"""Lanczos tridiagonalization and stochastic Lanczos quadrature (SLQ) log-det.

Counterpart of ``gp_grief_tpu.ops.lanczos`` (``lanczos``,
``lanczos_batched``, ``_slq_quadrature``, ``slq_logdet``, and the host
float64 quadrature of probe chunks: ``_probe_chunk_sizes``,
``_chunk_quadrature_total``, ``_np_slq_quadrature``, which the fused CG +
SLQ driver of ``ops/fused.py`` runs).  The recurrences are Python loops of a
fixed length with the JAX package's masked arithmetic (breakdown freezes a
recurrence without a host branch), so nothing reads the device until the
quadrature's result.  The iteration-segmented loops of the JAX package exist
for a TPU runtime's per-program time limit and have no counterpart here.

Probes are Rademacher vectors drawn by :func:`rademacher`, the one draw
function of the package, from an explicit ``torch.Generator``.  ``jax.random``
and torch draw different bits, so a parity run replaces this function (tests
monkeypatch it with NumPy draws that the JAX side is handed as well).

``group=`` (the JAX package's ``axis_name``): the vectors' rows are sharded
over the ranks of a ``torch.distributed`` process group, and every inner
product and norm is all-reduced, so every rank runs the same recurrence.
A rank draws only its own rows of each probe, from the generator it is
given (JAX folds the device index into the key; here each rank passes its
own generator).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gp_grief_tpu_torch.ops.cg import _group_sum, _reducers

__all__ = ["LanczosResult", "lanczos", "lanczos_batched", "rademacher", "slq_logdet"]


class LanczosResult(NamedTuple):
    Q: Optional[torch.Tensor]  # (m, k) orthonormal basis, or None if not stored
    alpha: torch.Tensor  # (k,) tridiagonal diagonal (zero-padded past breakdown)
    beta: torch.Tensor  # (k-1,) tridiagonal off-diagonal (zero-padded)
    num_valid: torch.Tensor  # scalar: valid alpha entries before breakdown


def rademacher(shape, *, dtype, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """±1 entries of ``shape`` with equal probability, from ``generator``
    (on ``device``).  Every probe of the package is drawn here."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def lanczos(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v0: torch.Tensor,
    k: int,
    *,
    full_reorth: bool = True,
    store_basis: bool = True,
    group=None,
) -> LanczosResult:
    """Run ``k`` Lanczos steps of a symmetric operator from ``v0`` ``(m,)``;
    ``matvec`` maps ``(m, 1) → (m, 1)``.

    Produces ``T = tridiag(beta, alpha, beta)`` with ``Qᵀ A Q = T`` and
    (optionally) the orthonormal basis ``Q``.  Breakdown is masked: steps past
    it give zero columns and zero ``alpha``/``beta``, and ``num_valid`` counts
    the usable steps.  ``full_reorth`` (two passes against the stored basis)
    requires ``store_basis``.  ``group``: rows sharded (module docstring).
    """
    if full_reorth and not store_basis:
        raise ValueError("full_reorth requires store_basis=True")
    m = v0.shape[0]
    dtype, device = v0.dtype, v0.device
    eps = torch.finfo(dtype).eps
    _sum = _group_sum(group)
    q = v0 / torch.sqrt(_sum(torch.sum(v0 * v0)))
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros((), dtype=dtype, device=device)
    alive = torch.ones((), dtype=torch.bool, device=device)
    Qbuf = torch.zeros((m, k), dtype=dtype, device=device) if store_basis else None
    alphas, betas, alives = [], [], []
    for i in range(k):
        if store_basis:
            Qbuf[:, i] = torch.where(alive, q, torch.zeros_like(q))
        w = matvec(q[:, None])[:, 0]
        alpha_i = _sum(torch.sum(w * q))
        w = w - alpha_i * q - beta_prev * q_prev
        if full_reorth:
            # Orthogonalize against every stored vector (zeros beyond i are
            # inert); twice is enough (Parlett).
            for _ in range(2):
                w = w - Qbuf @ _sum(Qbuf.T @ w)
        beta_i = torch.sqrt(_sum(torch.sum(w * w)))
        scale = torch.abs(alpha_i) + beta_prev + 1.0
        broke = beta_i <= 100 * eps * scale
        q_next = torch.where(broke, torch.zeros_like(w), w / torch.where(beta_i == 0, torch.ones_like(beta_i), beta_i))
        alpha_out = torch.where(alive, alpha_i, torch.zeros_like(alpha_i))
        beta_out = torch.where(alive & ~broke, beta_i, torch.zeros_like(beta_i))
        alphas.append(alpha_out)
        betas.append(beta_out)
        alives.append(alive)
        q_prev, q, beta_prev, alive = q, q_next, beta_out, alive & ~broke
    return LanczosResult(
        Q=Qbuf,
        alpha=torch.stack(alphas),
        beta=torch.stack(betas)[:-1],
        num_valid=torch.sum(torch.stack(alives).to(torch.int64)),
    )


def lanczos_batched(matvec, V0: torch.Tensor, k: int, *, layout: str = "col", group=None):
    """``R`` independent Lanczos recurrences sharing each batched matvec.

    ``V0``: ``(m, R)`` start vectors (``layout="col"``) or ``(R, m)``
    (``layout="bm"``, each row a recurrence); ``matvec`` maps the block to a
    block of the same layout.  No reorthogonalization.  ``group``: rows
    sharded (module docstring).  Returns ``(alphas (k, R), betas (k-1, R),
    num_valid (R,))``.
    """
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    _colsum, _colnorm, _bc = _reducers(layout, group)
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


def _slq_quadrature(alpha: torch.Tensor, beta: torch.Tensor, num_valid: torch.Tensor, k: int) -> torch.Tensor:
    """Gauss-quadrature values ``Σ_j τ_j² log θ_j`` of a batch of
    tridiagonals: ``alpha (R, k)``, ``beta (R, k-1)``, ``num_valid (R,)`` →
    ``(R,)``.  The dead (post-breakdown) block gets a unit diagonal, so its
    eigenpairs sit at θ = 1 where log θ = 0."""
    T = torch.diag_embed(alpha) + torch.diag_embed(beta, 1) + torch.diag_embed(beta, -1)
    live = torch.arange(k, device=alpha.device)[None, :] < num_valid[:, None]  # (R, k)
    T = torch.where(live[:, :, None] & live[:, None, :], T, torch.zeros_like(T))
    T = T + torch.diag_embed(torch.where(live, torch.zeros_like(alpha), torch.ones_like(alpha)))
    theta, V = torch.linalg.eigh(T)
    tau = V[:, 0, :]
    theta_safe = torch.where(theta > 0, theta, torch.ones_like(theta))
    return torch.sum(tau * tau * torch.log(theta_safe), dim=-1)


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
    group=None,
) -> torch.Tensor:
    """Estimate ``log|A|`` for symmetric PD ``A`` by stochastic Lanczos
    quadrature: ``(1/R) Σ_r ‖z_r‖² Σ_j τ_j² log θ_j`` over Rademacher probes
    ``z_r`` (one :func:`rademacher` draw of ``(m, R)``, or ``(R, m)`` with
    ``layout="bm"``), each through ``lanczos_iters`` Lanczos steps, all
    probes batched through one matvec per step.  ``full_reorth`` runs one
    reorthogonalized recurrence per probe (small-``m`` accuracy checks; not
    with ``layout="bm"``).  ``group``: ``m`` is this rank's row count of a
    system sharded over the group; ``generator`` draws this rank's rows
    (module docstring)."""
    if layout == "bm" and full_reorth:
        raise ValueError("layout='bm' does not support full_reorth")
    k = int(lanczos_iters)
    _sum = _group_sum(group)

    if full_reorth:
        z = rademacher((num_probes, m), dtype=dtype, device=device, generator=generator)
        vals = []
        for zz in z:
            res = lanczos(matvec, zz, k, full_reorth=True, store_basis=True, group=group)
            q = _slq_quadrature(res.alpha[None], res.beta[None], res.num_valid[None], k)[0]
            vals.append(_sum(torch.sum(zz * zz)) * q)
        return torch.mean(torch.stack(vals))
    shape = (m, num_probes) if layout == "col" else (num_probes, m)
    Z = rademacher(shape, dtype=dtype, device=device, generator=generator)
    alphas, betas, num_valid = lanczos_batched(matvec, Z, k, layout=layout, group=group)
    znorm2 = _sum(torch.sum(Z * Z, dim=0 if layout == "col" else 1))
    return torch.mean(znorm2 * _slq_quadrature(alphas.T, betas.T, num_valid, k))


def _probe_chunk_sizes(num_probes: int, probe_chunk: int) -> list:
    """Partition ``num_probes`` probes into chunks of ``probe_chunk`` (the
    last one ragged)."""
    probe_chunk = max(1, min(int(probe_chunk), int(num_probes)))
    sizes = [probe_chunk] * (int(num_probes) // probe_chunk)
    if int(num_probes) % probe_chunk:
        sizes.append(int(num_probes) % probe_chunk)
    return sizes


def _chunk_quadrature_total(a_rows, b_rows, alive_rows, znorm2, k: int) -> float:
    """Host float64 SLQ quadrature of one probe chunk, ``Σ_r ‖z_r‖² Σ_j τ_j²
    log θ_j``, from the per-step Lanczos outputs fetched in blocks (each
    ``(steps, R)``; ``b_rows`` carries every step's β, the last dropped
    here)."""
    alphas = np.concatenate(a_rows).astype(np.float64)
    betas = np.concatenate(b_rows).astype(np.float64)
    alive = np.concatenate(alive_rows)
    num_valid = alive.sum(axis=0)
    zn = np.asarray(znorm2, dtype=np.float64)
    total = 0.0
    for j in range(zn.shape[0]):
        total += zn[j] * _np_slq_quadrature(alphas[:, j], betas[: k - 1, j], int(num_valid[j]), k)
    return total


def _np_slq_quadrature(alpha_col, beta_col, num_valid, k) -> float:
    """Host float64 :func:`_slq_quadrature` of one probe's tridiagonal."""
    T = np.diag(alpha_col) + np.diag(beta_col, 1) + np.diag(beta_col, -1)
    live = np.arange(k) < num_valid
    T = np.where(live[:, None] & live[None, :], T, 0.0)
    T = T + np.diag(np.where(live, 0.0, 1.0))
    theta, V = np.linalg.eigh(T)
    tau = V[0, :]
    theta_safe = np.where(theta > 0, theta, 1.0)
    return float(np.sum(tau * tau * np.log(theta_safe)))
