"""The port's CG, Lanczos/SLQ and fused CG + SLQ entry points as they were
before their ``group=`` hooks, copied verbatim (with the helpers they call,
which the hooks left unchanged, imported from the port): the oracle of the
``group=None`` bits in ``tests/test_torch_cg.py``."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gp_grief_tpu_torch.ops import lanczos as _lanczos
from gp_grief_tpu_torch.ops.cg import CGInfo, _as_batch, _cg_fixed, _implicit, _make_pcg_step, _no_gradient, _stop
from gp_grief_tpu_torch.ops.fused import _run_chunk, make_fused_cg_lanczos_step
from gp_grief_tpu_torch.ops.lanczos import (
    _chunk_quadrature_total,
    _probe_chunk_sizes,
    _slq_quadrature,
    lanczos,
)

Matvec = Callable[[torch.Tensor], torch.Tensor]
Operator = Matvec


def rademacher(shape, *, dtype, device, generator):
    """The port's one draw function (unchanged), looked up at each call."""
    return _lanczos.rademacher(shape, dtype=dtype, device=device, generator=generator)


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


def cg_segments(op: Matvec, rhs: torch.Tensor, *, tol: float, max_iters: int, segment_iters: int,
                state_dtype=None, M_inv: Optional[Matvec] = None, verbose: bool = False):
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
    Value only.  Returns ``(x, iterations)``."""
    if M_inv is not None and state_dtype is not None:
        raise ValueError("cg_segments: M_inv and state_dtype do not combine (the mixed segment is unpreconditioned)")
    _colsum, _colnorm, _bc = _reducers("bm")
    with torch.no_grad():
        bnorm = _colnorm(rhs)
        z0 = rhs if M_inv is None else M_inv(rhs)
        rz0 = _colsum(rhs * z0)
        state = (torch.zeros_like(rhs), rhs, z0, z0, rz0, torch.zeros(rz0.shape, dtype=torch.bool,
                                                                       device=rhs.device))
        stop = _stop(bnorm, tol)
        step = _make_pcg_step(op, M_inv if M_inv is not None else (lambda r_: r_), _colsum, _bc)
        rnorm = bnorm
        go = bool(torch.any(rnorm > stop))
        iters = 0
        for s in range(max(1, -(-int(max_iters) // int(segment_iters)))):
            if not go:
                break
            prev = rnorm
            if state_dtype is not None:
                state = _segment_mixed(op, state, segment_iters, _colsum, _bc, state_dtype)
            else:
                for _ in range(segment_iters):
                    state = step(*state)
            iters += segment_iters
            rnorm = _colnorm(state[1])
            # One read per segment: the stop test and the stagnation test.
            go, moved, rel = torch.stack([torch.any((rnorm > stop) & ~state[5]), torch.any(rnorm < prev / 1.2),
                                          torch.max(rnorm / torch.clamp_min(bnorm, 1e-30))]).tolist()
            if verbose:
                print(f"[cg_segments] segment {s + 1}: iters={iters} max_rel_resid={rel:.3e}")
            if not moved:
                break
    return state[0], iters


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
    """
    if not implicit_diff:
        _no_gradient("cg_solve", b, x0)
    bb, unsqueeze = _as_batch(b, layout)
    x0b = torch.zeros_like(bb) if x0 is None else _as_batch(x0, layout)[0]

    def raw(rhs, start):
        with torch.no_grad():
            if fixed_iters is not None:
                return _cg_fixed(matvec, rhs, start, fixed_iters, M_inv, layout)
            return _cg_raw(matvec, rhs, start, tol, max_iters, M_inv, layout)

    x, info = raw(bb, x0b)
    if implicit_diff:
        x = _implicit(x, bb, matvec, lambda g: raw(g, torch.zeros_like(g))[0])
    return (unsqueeze(x), info) if return_info else unsqueeze(x)


def lanczos_batched(matvec, V0: torch.Tensor, k: int, *, layout: str = "col"):
    """``R`` independent Lanczos recurrences sharing each batched matvec.

    ``V0``: ``(m, R)`` start vectors (``layout="col"``) or ``(R, m)``
    (``layout="bm"``, each row a recurrence); ``matvec`` maps the block to a
    block of the same layout.  No reorthogonalization.  Returns
    ``(alphas (k, R), betas (k-1, R), num_valid (R,))``.
    """
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    _colsum, _colnorm, _bc = _reducers(layout)
    dtype = V0.dtype
    eps = torch.finfo(dtype).eps
    R = V0.shape[1] if layout == "col" else V0.shape[0]
    q = V0 / _bc(_colnorm(V0))
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((R,), dtype=dtype, device=V0.device)
    alive = torch.ones((R,), dtype=torch.bool, device=V0.device)
    alphas, betas, alives = [], [], []
    for _ in range(k):
        w = matvec(q)
        alpha_i = _colsum(w * q)
        w = w - _bc(alpha_i) * q - _bc(beta_prev) * q_prev
        beta_i = _colnorm(w)
        scale = torch.abs(alpha_i) + beta_prev + 1.0
        broke = beta_i <= 100 * eps * scale
        q_next = torch.where(_bc(broke), torch.zeros_like(w),
                             w / _bc(torch.where(beta_i == 0, torch.ones_like(beta_i), beta_i)))
        alpha_out = torch.where(alive, alpha_i, torch.zeros_like(alpha_i))
        beta_out = torch.where(alive & ~broke, beta_i, torch.zeros_like(beta_i))
        alphas.append(alpha_out)
        betas.append(beta_out)
        alives.append(alive)
        q_prev, q, beta_prev, alive = q, q_next, beta_out, alive & ~broke
    return torch.stack(alphas), torch.stack(betas)[:-1], torch.sum(torch.stack(alives).to(torch.int64), dim=0)


def slq_logdet(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    m: int,
    *,
    generator: Optional[torch.Generator],
    num_probes: int = 32,
    lanczos_iters: int = 64,
    dtype=torch.float32,
    device=None,
    full_reorth: bool = False,
    layout: str = "col",
) -> torch.Tensor:
    """Estimate ``log|A|`` for symmetric PD ``A`` by stochastic Lanczos
    quadrature: ``(1/R) Σ_r ‖z_r‖² Σ_j τ_j² log θ_j`` over Rademacher probes
    ``z_r`` (one :func:`rademacher` draw of ``(m, R)``, or ``(R, m)`` with
    ``layout="bm"``), each through ``lanczos_iters`` Lanczos steps, all
    probes batched through one matvec per step.  ``full_reorth`` runs one
    reorthogonalized recurrence per probe (small-``m`` accuracy checks; not
    with ``layout="bm"``)."""
    if layout == "bm" and full_reorth:
        raise ValueError("layout='bm' does not support full_reorth")
    k = int(lanczos_iters)
    if full_reorth:
        z = rademacher((num_probes, m), dtype=dtype, device=device, generator=generator)
        vals = []
        for zz in z:
            res = lanczos(matvec, zz, k, full_reorth=True, store_basis=True)
            q = _slq_quadrature(res.alpha[None], res.beta[None], res.num_valid[None], k)[0]
            vals.append(torch.sum(zz * zz) * q)
        return torch.mean(torch.stack(vals))
    shape = (m, num_probes) if layout == "col" else (num_probes, m)
    Z = rademacher(shape, dtype=dtype, device=device, generator=generator)
    alphas, betas, num_valid = lanczos_batched(matvec, Z, k, layout=layout)
    znorm2 = torch.sum(Z * Z, dim=0 if layout == "col" else 1)
    return torch.mean(znorm2 * _slq_quadrature(alphas.T, betas.T, num_valid, k))


def fused_cg_slq(
    op: Operator,
    rhs: torch.Tensor,
    *,
    generator: Optional[torch.Generator],
    num_probes: int,
    lanczos_iters: int,
    probe_chunk: int = 8,
    cg_tol: float = 1e-6,
    cg_iters: int = 400,
    cg_segment_iters: int = 50,
    fuse_probes: bool = True,
    verbose: bool = False,
):
    """Solve ``A x = rhs`` by CG and estimate ``log|A|`` by SLQ on one
    operator, sharing its applications.

    ``op`` maps ``(B, m)`` rows to rows and must be whitened (see the module
    docstring); ``rhs`` is ``(Bc, m)``, normally one row.  The probe chunks
    (``probe_chunk`` probes each, drawn by ``ops.lanczos.rademacher`` from
    ``generator`` in order) run first: each runs ``lanczos_iters`` fused
    steps, which with ``fuse_probes`` also advance the CG solve (its rows
    freeze once they meet the tolerance), and without it leave CG to the
    segments.  Then plain CG segments of ``cg_segment_iters`` iterations
    (:func:`ops.cg._make_pcg_step`, no test inside) run until every row meets
    ``cg_tol`` (relative, clamped at 20·eps of the dtype) or the
    ``cg_iters`` budget is spent.  The device is read once per chunk (its
    ``(k, R)`` Lanczos outputs, the residual norms) and once per segment;
    the Gauss quadrature runs on the host in float64.

    Returns ``(x, logdet_mean, cg_iterations)``: the ``(Bc, m)`` solution,
    the SLQ estimate of ``log|A|`` (the mean over the probes), and the CG
    iterations dispatched.  The count is of dispatched iterations, so it can
    overcount the ones that did work: a row that converges early in a chunk
    or segment stays frozen (or, in a segment, keeps iterating) until that
    chunk or segment ends.
    """
    if num_probes <= 0:
        raise ValueError("num_probes must be positive")
    dtype, device = rhs.dtype, rhs.device
    m = rhs.shape[1]
    k = int(lanczos_iters)
    _colsum, _colnorm, _bc = _reducers("bm")

    x0 = torch.zeros_like(rhs)
    rz0 = _colsum(rhs * rhs)
    state = (x0, rhs, rhs, rhs, rz0, torch.zeros(rz0.shape, dtype=torch.bool, device=device))
    bnorm = torch.sqrt(rz0).cpu().numpy().astype(np.float64)
    eps, tiny = torch.finfo(dtype).eps, torch.finfo(dtype).tiny
    stop = max(float(cg_tol), 20.0 * eps) * np.maximum(bnorm, tiny)
    freeze = torch.as_tensor(stop * stop, dtype=dtype, device=device)
    step = make_fused_cg_lanczos_step(op, _colsum, _colnorm, _bc, freeze_rz=freeze)
    # Without fusion the probe chunks carry a CG state of no rows.
    no_rows = tuple(t[:0] for t in state)

    def report(what, iters, rnorm):
        if verbose:
            rel = float(np.max(rnorm / np.maximum(bnorm, 1e-30)))
            print(f"[fused_cg_slq] {what}: cg_iters={iters} max_rel_resid={rel:.3e}", flush=True)

    total, iters = 0.0, 0
    rnorm_h, dead_h = bnorm, np.zeros(bnorm.shape, bool)
    sizes = _probe_chunk_sizes(num_probes, probe_chunk)
    for c, r in enumerate(sizes):
        Z = _lanczos.rademacher((r, m), dtype=dtype, device=device, generator=generator)
        cg_in = state if fuse_probes else no_rows
        cg_out, (alphas, betas, alive) = _run_chunk(step, cg_in, Z, k, _colnorm, _bc)
        quad_in = torch.cat([alphas, betas, alive.to(dtype)], dim=1).cpu().numpy()
        a_h, b_h, alive_h = quad_in[:, :r], quad_in[:, r : 2 * r], quad_in[:, 2 * r :] != 0
        total += _chunk_quadrature_total([a_h], [b_h], [alive_h], torch.sum(Z * Z, dim=1).cpu().numpy(), k)
        if fuse_probes:
            state = cg_out
            iters += k
            rnorm_h = _colnorm(state[1]).cpu().numpy()
            dead_h = state[5].cpu().numpy()
        report(f"probe chunk {c + 1}/{len(sizes)}", iters, rnorm_h)

    pcg_step = _make_pcg_step(op, lambda r_: r_, _colsum, _bc)
    seg = int(cg_segment_iters)
    leftover = max(0, int(cg_iters) - iters)
    for s in range(-(-leftover // seg)):
        if not np.any((rnorm_h > stop) & ~dead_h):
            break
        for _ in range(seg):
            state = pcg_step(*state)
        iters += seg
        rnorm_h, dead_h = _colnorm(state[1]).cpu().numpy(), state[5].cpu().numpy()
        report(f"cg segment {s + 1}", iters, rnorm_h)
    return state[0], total / int(num_probes), iters
