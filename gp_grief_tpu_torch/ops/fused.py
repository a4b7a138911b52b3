"""Fused CG + Lanczos (SLQ) iterations sharing each operator application.

Counterpart of ``gp_grief_tpu.ops.fused`` (``make_fused_cg_lanczos_step``,
``fused_cg_slq_segment``, ``fused_cg_slq_segmented``).  The iterative NLML
needs a CG solve of ``A x = b`` (the quadratic term) and ``R`` Lanczos
recurrences on the same operator (the SLQ log-det probes).  When an apply
costs about the same for one row as for a few (GP-GRIEF's two skinny GEMMs
read Φ once whatever the batch), one ``(Bc + R, m)`` apply per iteration
advances both: row block ``[:Bc]`` carries CG's search directions, the rest
the Lanczos block.  The arithmetic is :func:`ops.cg._make_pcg_step`'s with
the identity preconditioner and :func:`ops.lanczos.lanczos_batched`'s step.

Batch-major layout only: states are ``(B, m)`` rows.

**The operator must be whitened.**  The step has no preconditioner hook
(``z = r``), so it is preconditioned CG only on an operator already
preconditioned on both sides, ``M^{-1/2} A M^{-1/2}`` (or on ``A`` itself,
unpreconditioned).  The caller that whitens checks that its ``M^{-1/2}`` is
SPD to working precision (``ops.precond.check_whitening``).

:func:`fused_cg_slq` is the one host driver, in place of the JAX package's
``fused_cg_slq_segmented`` and GP-GRIEF's inline copy of it.  It reads the
device once per probe chunk or CG segment, never once per iteration, and
runs the Gauss quadrature in float64 on the host.

``group=`` (the JAX package's ``axis_name``): the rows of every state are
this rank's shard of a system sharded over a ``torch.distributed`` process
group; the reductions are all-reduced, so every rank takes the same steps
and reads the same numbers (``ops.cg``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gp_grief_tpu_torch.ops import lanczos as _lanczos
from gp_grief_tpu_torch.ops.cg import _make_pcg_step, _reducers, _segment_span
from gp_grief_tpu_torch.ops.lanczos import _chunk_quadrature_total, _probe_chunk_sizes, _slq_quadrature
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["make_fused_cg_lanczos_step", "fused_cg_slq_segment", "fused_cg_slq"]

_chunk_span = _prof.site("gp_grief.slq.chunk", "probes", "iters", "fused")
_quadrature_span = _prof.site("gp_grief.slq.quadrature")

Operator = Callable[[torch.Tensor], torch.Tensor]


def make_fused_cg_lanczos_step(op: Operator, _colsum, _colnorm, _bc, freeze_rz=None):
    """One fused iteration: the CG state (``Bc`` rows) and ``R`` Lanczos
    recurrences through one ``op`` application on ``(Bc + R, m)``.

    ``cg_state``: ``(x, r, z, p, rz, dead)`` as in ``ops.cg``;
    ``lz_carry``: ``(q, q_prev, beta_prev, alive)`` as in
    ``ops.lanczos.lanczos_batched``.  Returns the advanced states and the
    step's Lanczos outputs ``(alpha_out, beta_out, alive)``.

    ``freeze_rz``: a per-row convergence threshold on ``rz = rᵀr`` (``stop²``
    for a residual-norm stop).  The probe phase advances CG for as many
    iterations as the recurrences run, with no stop of its own; a row that
    has converged freezes through the ``dead`` flag, as a breakdown does, so
    float32 CG cannot wander off a converged iterate.  ``None`` keeps the
    pure recurrence.
    """

    def step(cg_state, lz_carry):
        x, r, z, p, rz, dead = cg_state
        q, q_prev, beta_prev, alive = lz_carry
        Bc = p.shape[0]
        AV = op(torch.cat([p, q], dim=0))
        Ap, w = AV[:Bc], AV[Bc:]

        # CG: the arithmetic and guards of ops.cg._make_pcg_step, z = r.
        pAp = _colsum(p * Ap)
        ok = (pAp > 0) & (rz > 0) & torch.isfinite(pAp) & torch.isfinite(rz) & ~dead
        alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)), torch.zeros_like(pAp))
        x = x + _bc(alpha) * p
        r = r - _bc(alpha) * Ap
        z = r
        rz_new = _colsum(r * z)
        dead_new = dead | ~ok | ~torch.isfinite(rz_new)
        if freeze_rz is not None:
            dead_new = dead_new | (rz_new <= freeze_rz)
        safe_rz = torch.where(rz == 0, torch.ones_like(rz), rz)
        beta = torch.where(dead_new | (rz == 0), torch.zeros_like(rz), rz_new / safe_rz)
        p = z + _bc(beta) * p
        cg_next = (x, r, z, p, rz_new, dead_new)

        # Lanczos: the arithmetic of ops.lanczos.lanczos_batched.
        eps = torch.finfo(q.dtype).eps
        alpha_i = _colsum(w * q)
        w = w - _bc(alpha_i) * q - _bc(beta_prev) * q_prev
        beta_i = _colnorm(w)
        scale = torch.abs(alpha_i) + beta_prev + 1.0
        broke = beta_i <= 100 * eps * scale
        q_next = torch.where(_bc(broke), torch.zeros_like(w),
                             w / _bc(torch.where(beta_i == 0, torch.ones_like(beta_i), beta_i)))
        alpha_out = torch.where(alive, alpha_i, torch.zeros_like(alpha_i))
        beta_out = torch.where(alive & ~broke, beta_i, torch.zeros_like(beta_i))
        alive_next = alive & ~broke
        return cg_next, (q_next, q, beta_out, alive_next), (alpha_out, beta_out, alive)

    return step


def _lanczos_start(Z: torch.Tensor, _colnorm, _bc):
    R = Z.shape[0]
    q0 = Z / _bc(_colnorm(Z))
    return (q0, torch.zeros_like(q0), torch.zeros((R,), dtype=Z.dtype, device=Z.device),
            torch.ones((R,), dtype=torch.bool, device=Z.device))


def _run_chunk(step, cg_state, Z: torch.Tensor, k: int, _colnorm, _bc):
    """``k`` fused steps from the probe block ``Z``: the advanced CG state and
    the stacked outputs ``(alphas, betas, alive)``, each ``(k, R)``, on the
    device."""
    lz = _lanczos_start(Z, _colnorm, _bc)
    outs = []
    for _ in range(k):
        cg_state, lz, out = step(cg_state, lz)
        outs.append(out)
    return cg_state, tuple(torch.stack(t) for t in zip(*outs))


def fused_cg_slq_segment(op: Operator, cg_state, Z: torch.Tensor, lanczos_iters: int, *, freeze_rz=None,
                         group=None):
    """Advance a CG state (rows) by ``lanczos_iters`` iterations while running
    a full ``R``-probe Lanczos pass on the same operator.

    ``Z``: the ``(R, m)`` probe block.  Returns ``(cg_state, slq_mean)``,
    ``slq_mean`` this chunk's SLQ estimate of ``log|A|`` (the mean over its
    probes), from the quadrature on the device.  ``group``: rows sharded
    (module docstring; ``Z`` is this rank's rows of the probes).
    """
    _colsum, _colnorm, _bc = _reducers("bm", group)
    k = int(lanczos_iters)
    step = make_fused_cg_lanczos_step(op, _colsum, _colnorm, _bc, freeze_rz=freeze_rz)
    cg_state, (alphas, betas, alive) = _run_chunk(step, cg_state, Z, k, _colnorm, _bc)
    num_valid = torch.sum(alive.to(torch.int64), dim=0)
    znorm2 = _colsum(Z * Z)
    vals = znorm2 * _slq_quadrature(alphas.T, betas[:-1].T, num_valid, k)
    return cg_state, torch.mean(vals)


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
    group=None,
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

    ``group``: ``rhs`` is this rank's rows of a system sharded over the
    group, and ``generator`` draws this rank's rows of the probes (module
    docstring); every rank returns the same log-det and iterations.
    """
    if num_probes <= 0:
        raise ValueError("num_probes must be positive")
    dtype, device = rhs.dtype, rhs.device
    m = rhs.shape[1]
    k = int(lanczos_iters)
    _colsum, _colnorm, _bc = _reducers("bm", group)

    x0 = torch.zeros_like(rhs)
    rz0 = _colsum(rhs * rhs)
    state = (x0, rhs, rhs, rhs, rz0, torch.zeros(rz0.shape, dtype=torch.bool, device=device))
    with _prof.host_read("fused.start"):
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
        with _chunk_span(r, k, bool(fuse_probes)):
            Z = _lanczos.rademacher((r, m), dtype=dtype, device=device, generator=generator)
            cg_in = state if fuse_probes else no_rows
            cg_out, (alphas, betas, alive) = _run_chunk(step, cg_in, Z, k, _colnorm, _bc)
            quad_in = torch.cat([alphas, betas, alive.to(dtype)], dim=1)
            zn = _colsum(Z * Z)
            with _prof.host_read("fused.chunk", 2):
                quad_in, zn = quad_in.cpu().numpy(), zn.cpu().numpy()
            with _quadrature_span():
                a_h, b_h, alive_h = quad_in[:, :r], quad_in[:, r : 2 * r], quad_in[:, 2 * r :] != 0
                total += _chunk_quadrature_total([a_h], [b_h], [alive_h], zn, k)
            if fuse_probes:
                state = cg_out
                iters += k
                rn = _colnorm(state[1])
                with _prof.host_read("fused.chunk", 2):
                    rnorm_h, dead_h = rn.cpu().numpy(), state[5].cpu().numpy()
        report(f"probe chunk {c + 1}/{len(sizes)}", iters, rnorm_h)

    pcg_step = _make_pcg_step(op, lambda r_: r_, _colsum, _bc)
    seg = int(cg_segment_iters)
    leftover = max(0, int(cg_iters) - iters)
    for s in range(-(-leftover // seg)):
        if not np.any((rnorm_h > stop) & ~dead_h):
            break
        with _segment_span(seg):
            for _ in range(seg):
                state = pcg_step(*state)
            iters += seg
            rn = _colnorm(state[1])
            with _prof.host_read("fused.segment", 2):
                rnorm_h, dead_h = rn.cpu().numpy(), state[5].cpu().numpy()
        report(f"cg segment {s + 1}", iters, rnorm_h)
    _prof.count("cg_iterations", iters)
    return state[0], total / int(num_probes), iters
