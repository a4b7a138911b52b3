"""Cholesky helpers: triangular solves, log-determinants, jitter escalation.

Counterpart of ``gp_grief_tpu.ops.solve``.  Factorizations use
``torch.linalg.cholesky_ex`` and turn a failed factor into NaNs instead of
raising, as ``jnp.linalg.cholesky`` does: a training step at a non-PD point
then shows up as a non-finite loss, which ``fit`` rejects.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["cholesky", "solve_chol", "stable_cholesky", "logdet_from_chol"]


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorization failed.  Checking
    ``info`` on the device keeps the call free of a host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, torch.nan))


def solve_chol(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given ``A = L Lᵀ`` via two triangular solves."""
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    y = torch.linalg.solve_triangular(L, bb, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[:, 0] if squeeze else x


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """``log|A|`` from ``A = L Lᵀ``."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def stable_cholesky(
    A: torch.Tensor,
    *,
    initial_jitter: float = 0.0,
    max_tries: int = 5,
    jitter_scale: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky with deterministic jitter escalation, without host branches.

    Attempts ``chol(A + j·mean(diag A)·I)`` for ``j ∈ {initial_jitter,
    jitter_scale·10⁰, …, jitter_scale·10^{max_tries-1}}`` and keeps the first
    success.  A failed attempt re-factorizes the identity so it contributes
    finite, masked-out gradients.  Returns ``(L, jitter_used)``.
    """
    diag_mean = torch.mean(torch.diagonal(A))
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    jitters = [initial_jitter] + [jitter_scale * (10.0**i) for i in range(max_tries)]

    def attempt(j):
        M = A + j * diag_mean * eye
        ok = torch.all(torch.isfinite(cholesky(M)))
        return cholesky(torch.where(ok, M, eye)), ok

    L, ok = attempt(jitters[0])
    used = torch.as_tensor(jitters[0], dtype=A.dtype, device=A.device)
    for j in jitters[1:]:
        L_new, ok_new = attempt(j)
        take_new = torch.logical_and(~ok, ok_new)
        L = torch.where(take_new, L_new, L)
        used = torch.where(take_new, torch.as_tensor(j, dtype=A.dtype, device=A.device), used)
        ok = torch.logical_or(ok, ok_new)
    return L, used
