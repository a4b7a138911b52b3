"""Conjugate gradients on a matvec closure, with a host-side loop.

Counterpart of ``gp_grief_tpu.ops.cg`` (``CGInfo``, ``_reducers``,
``_cg_raw``, ``_make_pcg_step``, ``_cg_fixed``, ``cg_solve``,
``cg_solve_refined``).  Batched right-hand sides are solved together with
per-system step sizes.  The JAX ``while_loop`` becomes a Python loop whose
convergence test reads one ``(B,)`` residual vector per iteration; the
``lax.scan`` of :func:`_cg_fixed` becomes a loop with no test at all.  The
host-segmented solvers of the JAX package exist for a TPU runtime's
per-program time limit and have no counterpart here.

These are value solves: the implicit gradient (``lax.custom_linear_solve``)
comes with the training slice.  Until then :func:`cg_solve` and
:func:`cg_solve_refined` raise ``NotImplementedError`` when a gradient is
required through them, rather than returning a solution that autograd would
differentiate through the iterations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["CGInfo", "cg_solve", "cg_solve_refined"]

Matvec = Callable[[torch.Tensor], torch.Tensor]


class CGInfo(NamedTuple):
    """Solver instrumentation: iterations executed and final residual norms.
    ``fallback_iterations`` (the port's addition) counts the exact-CG
    iterations :func:`cg_solve_refined` ran after refinement missed the
    tolerance; 0 when refinement converged on its own."""

    iterations: int
    residual_norm: torch.Tensor  # (B,)
    fallback_iterations: int = 0


def _reducers(layout: str):
    """Per-system reduction and broadcast helpers: ``layout="col"`` holds
    systems as columns of ``(m, B)``, ``layout="bm"`` as rows of ``(B, m)``."""
    red_axis = 0 if layout == "col" else 1

    def colsum(t):
        return torch.sum(t, dim=red_axis)

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


def _stop(bnorm: torch.Tensor, tol: float) -> torch.Tensor:
    # Clamp the relative tolerance at ~20·eps of the working dtype: an f64
    # default (1e-10) is unreachable in f32 and would spin to max_iters.
    eff_tol = max(float(tol), 20.0 * torch.finfo(bnorm.dtype).eps)
    return eff_tol * torch.clamp_min(bnorm, torch.finfo(bnorm.dtype).tiny)


def _cg_raw(matvec, b, x0, tol, max_iters, M_inv, layout="col"):
    """Preconditioned CG on ``b`` ``(m, B)`` (``"col"``) or ``(B, m)``
    (``"bm"``) until every live system meets ``tol`` or ``max_iters``."""
    _colsum, _colnorm, _bc = _reducers(layout)
    stop = _stop(_colnorm(b), tol)
    precond = M_inv if M_inv is not None else (lambda r: r)
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = _colsum(r * z)
    dead = torch.zeros(rz.shape, dtype=torch.bool, device=b.device)
    step = _make_pcg_step(matvec, precond, _colsum, _bc)
    x, k = x0, 0
    while k < max_iters and bool(torch.any((_colnorm(r) > stop) & ~dead)):
        x, r, z, p, rz, dead = step(x, r, z, p, rz, dead)
        k += 1
    return x, CGInfo(iterations=k, residual_norm=_colnorm(r))


def _cg_fixed(matvec, b, x0, num_iters, M_inv, layout="col", state_dtype=None):
    """Exactly ``num_iters`` CG iterations, with no convergence test.

    ``state_dtype`` (e.g. ``torch.bfloat16``) stores the carried ``r`` and ``p``
    in that dtype and hands the matvec its input in it; the
    ``x`` accumulator, the reductions and the update arithmetic stay in
    ``b``'s dtype.  The stagnation floor rises to about that dtype's epsilon,
    so it serves inner solves whose accuracy an outer refinement restores."""
    _colsum, _, _bc = _reducers(layout)
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
    return x, CGInfo(iterations=num_iters, residual_norm=torch.sqrt(_colsum(r32 * r32)))


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
            f"{name}: gradients through the solve (the implicit adjoint solve) are not ported "
            "yet; call it under torch.no_grad() or on tensors that do not require grad"
        )


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
):
    """Solve ``A x = b`` for symmetric positive-definite ``A`` given its matvec.

    ``b``: ``(m,)`` or ``(m, B)``; ``(B, m)`` when ``layout="bm"`` (each row a
    system; the matvec then takes ``(B, m)``).  ``tol`` is the relative
    residual per system (clamped at 20·eps of the dtype), ``max_iters`` the
    cap; ``M_inv`` an optional preconditioner ``v ↦ M⁻¹v`` in the same
    layout; ``fixed_iters`` runs exactly that many iterations with no
    convergence test.  Returns ``x`` (and :class:`CGInfo` with
    ``return_info``).  Value only: raises ``NotImplementedError`` when ``b``
    or ``x0`` requires grad with grad mode on.
    """
    _no_gradient("cg_solve", b, x0)
    bb, unsqueeze = _as_batch(b, layout)
    x0b = torch.zeros_like(bb) if x0 is None else _as_batch(x0, layout)[0]
    with torch.no_grad():
        if fixed_iters is not None:
            x, info = _cg_fixed(matvec, bb, x0b, fixed_iters, M_inv, layout)
        else:
            x, info = _cg_raw(matvec, bb, x0b, tol, max_iters, M_inv, layout)
    return (unsqueeze(x), info) if return_info else unsqueeze(x)


def _refined(matvec_fast, matvec_exact, rhs, tol, inner_iters, max_restarts, M_inv, layout, state_dtype):
    _, _colnorm, _bc = _reducers(layout)
    bnorm = _colnorm(rhs)
    stop = tol * torch.clamp_min(bnorm, torch.finfo(rhs.dtype).tiny)
    x = torch.zeros_like(rhs)
    x_best = x
    rnorm = rnorm_best = bnorm
    outer = 0
    while outer < max_restarts and bool(torch.any(rnorm_best > stop)):
        # Divergence brake: once the current residual exceeds 100x the best
        # seen, further restarts are hopeless (κ beyond the fast matvec's
        # precision); keep the best iterate.
        if bool(torch.all(rnorm > 100.0 * torch.maximum(rnorm_best, stop))):
            break
        r = rhs - matvec_exact(x)
        d, _ = _cg_fixed(matvec_fast, r, None, inner_iters, M_inv, layout, state_dtype)
        x = x + d
        rnorm = _colnorm(rhs - matvec_exact(x))
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
    if bool(torch.any(rnorm_best > stop)):
        xf, info = _cg_raw(matvec_exact, rhs, x_best, tol, inner_iters * max_restarts, M_inv, layout)
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
    iterations, with ``return_info``).  Value only: raises
    ``NotImplementedError`` when ``b`` requires grad with grad mode on.
    """
    _no_gradient("cg_solve_refined", b)
    bb, unsqueeze = _as_batch(b, layout)
    with torch.no_grad():
        x, rnorm, outer, fallback = _refined(
            matvec_fast, matvec_exact, bb, tol, inner_iters, max_restarts, M_inv, layout, state_dtype
        )
    if return_info:
        return unsqueeze(x), CGInfo(iterations=outer * inner_iters, residual_norm=rnorm,
                                    fallback_iterations=fallback)
    return unsqueeze(x)
