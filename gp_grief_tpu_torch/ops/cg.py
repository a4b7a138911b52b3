"""Conjugate gradients on a matvec closure, with a host-side loop.

Counterpart of ``gp_grief_tpu.ops.cg`` (``CGInfo``, ``_reducers``,
``_cg_raw``, ``_make_pcg_step``, ``_cg_fixed``, ``cg_solve``,
``cg_solve_refined``).  Batched right-hand sides are solved together with
per-system step sizes.  The JAX ``while_loop`` becomes a Python loop whose
convergence test reads one ``(B,)`` residual vector per iteration; the
``lax.scan`` of :func:`_cg_fixed` becomes a loop with no test at all.  The
JAX package's host-segmented solvers exist for a TPU runtime's per-program
time limit and have no counterpart here; :func:`cg_segments` is the host
driver of SKI's training solves, which keep their segment-level stop.

``group=`` (a ``torch.distributed`` process group; the JAX package's
``axis_name``) solves a system whose rows are sharded over the group's
ranks: every inner product and norm, and so every stopping test, reads the
all-reduced value, and every rank takes the same iterations.  The matvec
then maps this rank's rows to its rows, making its own collectives.
``group=None`` reduces nothing.

:func:`cg_solve` and :func:`cg_solve_refined` are differentiable by the
implicit adjoint (``lax.custom_linear_solve(symmetric=True)`` in the JAX
package): the iterations run under ``torch.no_grad()``, and autograd sees
``x = x* + S(b − A x*)``, where ``S`` returns zeros forward and one more
solve ``A⁻¹g`` backward.  So ``dx = A⁻¹(db − dA·x*)`` reaches ``b`` and every
tensor the defining matvec closes over, with no parameter list, and the
values are the solver's own bits.  ``implicit_diff=False`` keeps a value
solve, which raises when a gradient is required through it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gp_grief_tpu_torch.ops.collectives import psum
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["CGInfo", "cg_segments", "cg_solve", "cg_solve_refined"]

_solve_span = _prof.site("gp_grief.cg.solve", "rows", "cols", "refined")
_segment_span = _prof.site("gp_grief.cg.segment", "iters")

Matvec = Callable[[torch.Tensor], torch.Tensor]


class CGInfo(NamedTuple):
    """Solver instrumentation: iterations executed and final residual norms.
    ``fallback_iterations`` (the port's addition) counts the exact-CG
    iterations :func:`cg_solve_refined` ran after refinement missed the
    tolerance; 0 when refinement converged on its own."""

    iterations: int
    residual_norm: torch.Tensor  # (B,)
    fallback_iterations: int = 0


def _group_sum(group):
    """The identity, or with a ``group`` the sum over its ranks (``psum``)."""
    if group is None:
        return lambda t: t
    return lambda t: psum(t, group)


def _reducers(layout: str, group=None):
    """Per-system reduction and broadcast helpers: ``layout="col"`` holds
    systems as columns of ``(m, B)``, ``layout="bm"`` as rows of ``(B, m)``.
    With a ``group``, the sums are all-reduced over its ranks."""
    red_axis = 0 if layout == "col" else 1
    reduce = _group_sum(group)

    def colsum(t):
        return reduce(torch.sum(t, dim=red_axis))

    def colnorm(t):
        return torch.sqrt(colsum(t * t))

    def bc(a):  # broadcast a (B,) per-system scalar against the state
        return a[None, :] if red_axis == 0 else a[:, None]

    return colsum, colnorm, bc


def _make_pcg_step(matvec, precond, _colsum, _bc):
    """One preconditioned-CG iteration on state ``(x, r, z, p, rz, dead)``."""

    def step(x, r, z, p, rz, dead):
        Ap = matvec(p)
        pAp = _colsum(p * Ap)
        # Breakdown guard: a system whose curvature pAp or preconditioned
        # product rz is non-positive (lost to rounding on an ill-conditioned
        # operator, or rz = 0 at full convergence) or non-finite is frozen for
        # good at its current iterate; live systems keep stepping.
        ok = (pAp > 0) & (rz > 0) & torch.isfinite(pAp) & torch.isfinite(rz) & ~dead
        alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)), torch.zeros_like(pAp))
        x = x + _bc(alpha) * p
        r = r - _bc(alpha) * Ap
        z = precond(r)
        rz_new = _colsum(r * z)
        dead = dead | ~ok | ~torch.isfinite(rz_new)
        safe_rz = torch.where(rz == 0, torch.ones_like(rz), rz)
        beta = torch.where(dead | (rz == 0), torch.zeros_like(rz), rz_new / safe_rz)
        p = z + _bc(beta) * p
        return x, r, z, p, rz_new, dead

    return step


def _flag(t: torch.Tensor, site: str) -> bool:
    """``bool(t)``: one synchronising host read, spanned and counted."""
    with _prof.host_read(site):
        return bool(t)


def _stop(bnorm: torch.Tensor, tol: float) -> torch.Tensor:
    # Clamp the relative tolerance at ~20·eps of the working dtype: an f64
    # default (1e-10) is unreachable in f32 and would spin to max_iters.
    eff_tol = max(float(tol), 20.0 * torch.finfo(bnorm.dtype).eps)
    return eff_tol * torch.clamp_min(bnorm, torch.finfo(bnorm.dtype).tiny)


def _cg_raw(matvec, b, x0, tol, max_iters, M_inv, layout="col", group=None):
    """Preconditioned CG on ``b`` ``(m, B)`` (``"col"``) or ``(B, m)``
    (``"bm"``) until every live system meets ``tol`` or ``max_iters``."""
    _colsum, _colnorm, _bc = _reducers(layout, group)
    stop = _stop(_colnorm(b), tol)
    precond = M_inv if M_inv is not None else (lambda r: r)
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = _colsum(r * z)
    dead = torch.zeros(rz.shape, dtype=torch.bool, device=b.device)
    step = _make_pcg_step(matvec, precond, _colsum, _bc)
    x, k = x0, 0
    while k < max_iters and _flag(torch.any((_colnorm(r) > stop) & ~dead), "cg.solve"):
        x, r, z, p, rz, dead = step(x, r, z, p, rz, dead)
        k += 1
    _prof.count("cg_iterations", k)
    return x, CGInfo(iterations=k, residual_norm=_colnorm(r))


def _cg_fixed(matvec, b, x0, num_iters, M_inv, layout="col", state_dtype=None, group=None):
    """Exactly ``num_iters`` CG iterations, with no convergence test.

    ``state_dtype`` (e.g. ``torch.bfloat16``) stores the carried ``r`` and ``p``
    in that dtype and hands the matvec its input in it; the
    ``x`` accumulator, the reductions and the update arithmetic stay in
    ``b``'s dtype.  The stagnation floor rises to about that dtype's epsilon,
    so it serves inner solves whose accuracy an outer refinement restores."""
    _colsum, _, _bc = _reducers(layout, group)
    wd = b.dtype
    sd = None if state_dtype is None or state_dtype == wd else state_dtype
    _st = (lambda a: a.to(sd)) if sd is not None else (lambda a: a)
    has_pre = M_inv is not None

    if x0 is None:  # known-zero start: r0 = b, no matvec
        x = torch.zeros_like(b)
        r0 = b
    else:
        x = x0
        r0 = (b - matvec(x0)).to(wd)
    z0 = (M_inv(r0) if has_pre else r0).to(wd)
    rz = _colsum(r0 * z0)
    dead = torch.zeros(rz.shape, dtype=torch.bool, device=b.device)
    r, p = _st(r0), _st(z0)
    for _ in range(num_iters):
        Ap = matvec(p)
        p32 = p.to(wd)
        Ap32 = Ap.to(wd)
        pAp = _colsum(p32 * Ap32)
        # Same permanent breakdown freeze as _make_pcg_step.
        ok = (pAp > 0) & (rz > 0) & torch.isfinite(pAp) & torch.isfinite(rz) & ~dead
        alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)), torch.zeros_like(pAp))
        x = x + _bc(alpha) * p32
        r32 = r.to(wd) - _bc(alpha) * Ap32
        z32 = M_inv(r32) if has_pre else r32
        rz_new = _colsum(r32 * z32)
        dead = dead | ~ok | ~torch.isfinite(rz_new)
        safe_rz = torch.where(rz == 0, torch.ones_like(rz), rz)
        beta = torch.where(dead | (rz == 0), torch.zeros_like(rz), rz_new / safe_rz)
        p = _st(z32 + _bc(beta) * p32)
        r = _st(r32)
        rz = rz_new
    r32 = r.to(wd)
    _prof.count("cg_iterations", num_iters)
    return x, CGInfo(iterations=num_iters, residual_norm=torch.sqrt(_colsum(r32 * r32)))


def _segment_mixed(matvec, state, segment_iters, _colsum, _bc, state_dtype):
    """``segment_iters`` unpreconditioned CG iterations on ``(x, r, z, p, rz,
    dead)`` with ``r`` and ``p`` carried, and handed to the matvec, in
    ``state_dtype`` (:func:`_cg_fixed`'s mixed16 body).  The state enters and
    leaves in its own dtype with ``z == r`` (JAX ``_segment_scan_mixed``)."""
    x, r, _, p, rz, dead = state
    wd = x.dtype
    r, p = r.to(state_dtype), p.to(state_dtype)
    for _ in range(segment_iters):
        Ap = matvec(p)
        p32, Ap32 = p.to(wd), Ap.to(wd)
        pAp = _colsum(p32 * Ap32)
        # Same permanent breakdown freeze as _make_pcg_step.
        ok = (pAp > 0) & (rz > 0) & torch.isfinite(pAp) & torch.isfinite(rz) & ~dead
        alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)), torch.zeros_like(pAp))
        x = x + _bc(alpha) * p32
        r32 = r.to(wd) - _bc(alpha) * Ap32
        rz_new = _colsum(r32 * r32)
        dead = dead | ~ok | ~torch.isfinite(rz_new)
        safe_rz = torch.where(rz == 0, torch.ones_like(rz), rz)
        beta = torch.where(dead | (rz == 0), torch.zeros_like(rz), rz_new / safe_rz)
        p = (r32 + _bc(beta) * p32).to(state_dtype)
        r = r32.to(state_dtype)
        rz = rz_new
    r = r.to(wd)
    return x, r, r, p.to(wd), rz, dead


def cg_segments(op: Matvec, rhs: torch.Tensor, *, tol: float, max_iters: int, segment_iters: int,
                state_dtype=None, M_inv: Optional[Matvec] = None, verbose: bool = False, group=None):
    """CG on ``op`` (an operator on ``(B, m)`` rows) from zero, in segments
    of ``segment_iters`` iterations with one host read after each: the host
    driver of the JAX package's segmented solves (``gp_ski.py:1187-1228``,
    ``gp_kron.py:315``).

    It stops when every live row meets ``tol`` (relative, clamped at 20·eps),
    after ``ceil(max_iters / segment_iters)`` segments, or when a segment
    shrinks no row's residual by 1.2× (the arithmetic floor: bf16 state sits
    near 3.6e-3 relative).  ``M_inv`` preconditions the iterations (on
    ``(B, m)`` rows; data-space PCG, as JAX's segmented grid NLML runs it);
    ``state_dtype`` runs each segment unpreconditioned with that state
    (:func:`_segment_mixed`).  ``verbose`` prints one line per segment.
    ``group``: rows sharded over its ranks (module docstring); the one read
    per segment is of all-reduced norms, the same on every rank.
    Value only.  Returns ``(x, iterations)``."""
    if M_inv is not None and state_dtype is not None:
        raise ValueError("cg_segments: M_inv and state_dtype do not combine (the mixed segment is unpreconditioned)")
    _colsum, _colnorm, _bc = _reducers("bm", group)
    with torch.no_grad():
        bnorm = _colnorm(rhs)
        z0 = rhs if M_inv is None else M_inv(rhs)
        rz0 = _colsum(rhs * z0)
        state = (torch.zeros_like(rhs), rhs, z0, z0, rz0, torch.zeros(rz0.shape, dtype=torch.bool,
                                                                       device=rhs.device))
        stop = _stop(bnorm, tol)
        step = _make_pcg_step(op, M_inv if M_inv is not None else (lambda r_: r_), _colsum, _bc)
        rnorm = bnorm
        go = _flag(torch.any(rnorm > stop), "cg.segments")
        iters = 0
        for s in range(max(1, -(-int(max_iters) // int(segment_iters)))):
            if not go:
                break
            with _segment_span(int(segment_iters)):
                prev = rnorm
                if state_dtype is not None:
                    state = _segment_mixed(op, state, segment_iters, _colsum, _bc, state_dtype)
                else:
                    for _ in range(segment_iters):
                        state = step(*state)
                iters += segment_iters
                rnorm = _colnorm(state[1])
                # One read per segment: the stop test and the stagnation test.
                tests = torch.stack([torch.any((rnorm > stop) & ~state[5]), torch.any(rnorm < prev / 1.2),
                                     torch.max(rnorm / torch.clamp_min(bnorm, 1e-30))])
                with _prof.host_read("cg.segments"):
                    go, moved, rel = tests.tolist()
            if verbose:
                print(f"[cg_segments] segment {s + 1}: iters={iters} max_rel_resid={rel:.3e}")
            if not moved:
                break
    _prof.count("cg_iterations", iters)
    return state[0], iters


def _as_batch(b: torch.Tensor, layout: str):
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    squeeze = b.ndim == 1
    bb = (b[:, None] if layout == "col" else b[None, :]) if squeeze else b

    def unsqueeze(x):
        if not squeeze:
            return x
        return x[:, 0] if layout == "col" else x[0]

    return bb, unsqueeze


def _no_gradient(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}(implicit_diff=False) is a value solve with no gradient; call it under "
            "torch.no_grad(), or with implicit_diff=True to differentiate through the solve"
        )


class _AdjointSolve(torch.autograd.Function):
    """``x`` forward, unchanged; backward, ``solve(g)`` to ``r`` and nothing to
    ``x``.  With ``r = b − A x*`` recorded by autograd this is the implicit
    gradient of ``x* = A⁻¹b`` (``A`` symmetric)."""

    @staticmethod
    def forward(ctx, solve, x, r):
        ctx.solve = solve
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return None, None, ctx.solve(g.contiguous())


def _implicit(x: torch.Tensor, b: torch.Tensor, matvec: Matvec, solve: Callable) -> torch.Tensor:
    """Attach the implicit gradient to the solution ``x`` of ``matvec(x) = b``.

    The residual correction around ``x`` (JAX ``cg.py:352-361``'s warm start):
    one more apply of ``matvec`` with autograd recording, only when grad mode
    is on, and ``x`` itself when nothing it computes requires grad."""
    if not torch.is_grad_enabled():
        return x
    r = b - matvec(x)
    if not r.requires_grad:
        return x
    return _AdjointSolve.apply(solve, x, r)


def cg_solve(
    matvec: Matvec,
    b: torch.Tensor,
    *,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-10,
    max_iters: int = 1000,
    M_inv: Optional[Matvec] = None,
    return_info: bool = False,
    fixed_iters: Optional[int] = None,
    layout: str = "col",
    implicit_diff: bool = True,
    group=None,
):
    """Solve ``A x = b`` for symmetric positive-definite ``A`` given its matvec.

    ``b``: ``(m,)`` or ``(m, B)``; ``(B, m)`` when ``layout="bm"`` (each row a
    system; the matvec then takes ``(B, m)``).  ``tol`` is the relative
    residual per system (clamped at 20·eps of the dtype), ``max_iters`` the
    cap; ``M_inv`` an optional preconditioner ``v ↦ M⁻¹v`` in the same
    layout; ``fixed_iters`` runs exactly that many iterations with no
    convergence test.  Returns ``x`` (and :class:`CGInfo` with
    ``return_info``).

    ``implicit_diff`` (default): gradients reach ``b`` and the tensors
    ``matvec`` closes over, through one more solve of the same kind from a
    zero start (``M_inv`` preconditions it and carries no gradient; ``x0``
    carries none either, since the solution does not depend on it).  Unlike
    the JAX package, ``return_info=True`` stays differentiable.
    ``implicit_diff=False``: a value solve, raising ``NotImplementedError``
    when ``b`` or ``x0`` requires grad with grad mode on.

    ``group``: the rows of ``b`` (and of the matvec's input and output) are
    this rank's shard of a system sharded over the group (module docstring).
    """
    if not implicit_diff:
        _no_gradient("cg_solve", b, x0)
    bb, unsqueeze = _as_batch(b, layout)
    x0b = torch.zeros_like(bb) if x0 is None else _as_batch(x0, layout)[0]

    def raw(rhs, start):
        with torch.no_grad(), _solve_span(int(rhs.shape[0]), int(rhs.shape[1]), False):
            if fixed_iters is not None:
                return _cg_fixed(matvec, rhs, start, fixed_iters, M_inv, layout, group=group)
            return _cg_raw(matvec, rhs, start, tol, max_iters, M_inv, layout, group)

    x, info = raw(bb, x0b)
    if implicit_diff:
        x = _implicit(x, bb, matvec, lambda g: raw(g, torch.zeros_like(g))[0])
    return (unsqueeze(x), info) if return_info else unsqueeze(x)


def _refined(matvec_fast, matvec_exact, rhs, tol, inner_iters, max_restarts, M_inv, layout, state_dtype,
             group=None):
    _, _colnorm, _bc = _reducers(layout, group)
    bnorm = _colnorm(rhs)
    stop = tol * torch.clamp_min(bnorm, torch.finfo(rhs.dtype).tiny)
    x = torch.zeros_like(rhs)
    x_best = x
    rnorm = rnorm_best = bnorm
    # The exact residual of the current iterate, refreshed once per restart
    # and carried into the next one (JAX ``cg_solve_refined_segmented``'s
    # ``refresh``): 1 + restarts exact applies in all, plus the fallback's.
    r = rhs - matvec_exact(x)
    outer = 0
    while outer < max_restarts and _flag(torch.any(rnorm_best > stop), "cg.refined"):
        # Divergence brake: once the current residual exceeds 100x the best
        # seen, further restarts are hopeless (κ beyond the fast matvec's
        # precision); keep the best iterate.
        if _flag(torch.all(rnorm > 100.0 * torch.maximum(rnorm_best, stop)), "cg.refined"):
            break
        d, _ = _cg_fixed(matvec_fast, r, None, inner_iters, M_inv, layout, state_dtype, group)
        x = x + d
        r = rhs - matvec_exact(x)
        rnorm = _colnorm(r)
        # NaN-poisoning guard: the low-precision inner CG can overflow its
        # iterate one step before its own freeze triggers, making rnorm NaN;
        # `NaN > stop` is False and would read as converged and skip the
        # fallback (a wrong NLML at the m = 33.5M / rank-512 configuration,
        # benchmarks/RESULTS_r5.md §12).  Non-finite residuals count as +inf.
        rnorm = torch.where(torch.isfinite(rnorm), rnorm, torch.full_like(rnorm, torch.inf))
        better = rnorm < rnorm_best
        x_best = torch.where(_bc(better), x, x_best)
        rnorm_best = torch.minimum(rnorm, rnorm_best)
        outer += 1

    fallback = 0
    # Any system above tolerance after refinement finishes with exact CG
    # warm-started from the best iterate, so "mixed" is never worse than
    # "exact" in result, only in time (benchmarks/RESULTS_r5.md §12).
    if _flag(torch.any(rnorm_best > stop), "cg.refined"):
        xf, info = _cg_raw(matvec_exact, rhs, x_best, tol, inner_iters * max_restarts, M_inv, layout, group)
        better = info.residual_norm < rnorm_best
        x_best = torch.where(_bc(better), xf, x_best)
        rnorm_best = torch.minimum(info.residual_norm, rnorm_best)
        fallback = info.iterations
    return x_best, rnorm_best, outer, fallback


def cg_solve_refined(
    matvec_fast: Matvec,
    matvec_exact: Matvec,
    b: torch.Tensor,
    *,
    tol: float = 1e-6,
    inner_iters: int = 50,
    max_restarts: int = 20,
    M_inv: Optional[Matvec] = None,
    return_info: bool = False,
    layout: str = "col",
    state_dtype=None,
    implicit_diff: bool = True,
    group=None,
):
    """Mixed-precision CG by iterative refinement (Carson–Higham).

    Outer loop: ``r ← b − A_exact x``; inner loop: ``inner_iters`` CG
    iterations on ``A d = r`` with the fast (e.g. bf16-operand) matvec;
    ``x ← x + d``.  The exact residual refreshes govern the final accuracy.
    A divergence brake keeps the best iterate, non-finite residuals count as
    +inf, and any system still above ``tol`` finishes with exact CG.
    ``state_dtype`` (e.g. ``torch.bfloat16``) stores the inner loop's state
    in that dtype and hands ``matvec_fast`` its input in it (mixed16).

    Returns ``x`` (and :class:`CGInfo` with ``iterations`` = restarts ×
    ``inner_iters``, the final true residual norms and the fallback's
    iterations, with ``return_info``).

    ``implicit_diff`` (default): differentiable as :func:`cg_solve`, with
    ``matvec_exact`` the defining operator: the backward is one more refined
    solve, and gradients reach ``b`` and the tensors ``matvec_exact`` closes
    over, not ``matvec_fast``'s or ``M_inv``'s.  ``implicit_diff=False``: a
    value solve, raising ``NotImplementedError`` when ``b`` requires grad
    with grad mode on.  ``group``: rows sharded, as in :func:`cg_solve`.
    """
    if not implicit_diff:
        _no_gradient("cg_solve_refined", b)
    bb, unsqueeze = _as_batch(b, layout)

    def raw(rhs):
        with torch.no_grad(), _solve_span(int(rhs.shape[0]), int(rhs.shape[1]), True):
            return _refined(matvec_fast, matvec_exact, rhs, tol, inner_iters, max_restarts, M_inv, layout,
                            state_dtype, group)

    x, rnorm, outer, fallback = raw(bb)
    if implicit_diff:
        x = _implicit(x, bb, matvec_exact, lambda g: raw(g)[0])
    if return_info:
        return unsqueeze(x), CGInfo(iterations=outer * inner_iters, residual_norm=rnorm,
                                    fallback_iterations=fallback)
    return unsqueeze(x)
