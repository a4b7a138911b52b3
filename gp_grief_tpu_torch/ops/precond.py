"""Deflation preconditioners for the grid operator ``⊗K_d + σ²I``.

Counterpart of ``gp_grief_tpu.ops.precond`` (``kron_deflation_preconditioner``,
``kron_deflation_sqrt_ops``).  With ``A = QΛQᵀ + σ²I`` and ``Q_p`` the top-p
Kronecker eigencolumns, ``M = Q_p Λ_p Q_pᵀ + σ²I`` has closed-form spectral
functions

    f(M) = f(σ²)·I + Q_p (f(Λ_p + σ²) − f(σ²)) Q_pᵀ,

applied with two Kronecker matvecs (``⊗Q_dᵀ`` then ``⊗Q_d``, both through
:func:`~gp_grief_tpu_torch.ops.kron_fast.kron_matvec_fast` at full precision)
and a p-entry gather/scatter on the eigen-lattice; ``Q_p`` is never formed.
The low-rank and pivoted-Cholesky preconditioners come with the matrix-free
exact GP.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast

__all__ = ["kron_deflation_preconditioner", "kron_deflation_sqrt_ops"]


def kron_deflation_preconditioner(
    Qs: Sequence[torch.Tensor],
    lams: Sequence[torch.Tensor],
    idx: torch.Tensor,
    sigma2,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``M_inv(v)`` of the rank-p deflation (``Qs``/``lams`` from ``kron_eigh``,
    ``idx`` ``(p, d)`` from ``top_p_kron_eigs``); ``v`` ``(m,)`` or ``(m, B)``."""
    M_inv, _, _ = kron_deflation_sqrt_ops(Qs, lams, idx, sigma2)
    return M_inv


def kron_deflation_sqrt_ops(
    Qs: Sequence[torch.Tensor],
    lams: Sequence[torch.Tensor],
    idx: torch.Tensor,
    sigma2,
):
    """``(M_inv, M_inv_sqrt, logdet_M)`` of the rank-p Kronecker deflation.
    ``M_inv_sqrt`` whitens the grid operator for CG
    (``yᵀA⁻¹y = (M⁻½y)ᵀ(M⁻½AM⁻½)⁻¹(M⁻½y)``)."""
    Qs = tuple(Q.contiguous() for Q in Qs)
    # Kernel wrappers take contiguous operands only; Q.T is a strided view.
    QT = tuple(Q.T.contiguous() for Q in Qs)
    sizes = [int(Q.shape[0]) for Q in Qs]
    m = math.prod(sizes)
    p = int(idx.shape[0])
    lam_p = torch.ones((p,), dtype=Qs[0].dtype, device=Qs[0].device)
    for d in range(len(Qs)):
        lam_p = lam_p * lams[d][idx[:, d]]
    sigma2 = torch.as_tensor(sigma2, dtype=lam_p.dtype, device=lam_p.device)
    # Flat index of each selected eigenpair on the eigen-lattice (C order).
    strides = [math.prod(sizes[d + 1 :]) for d in range(len(sizes))]
    flat = torch.sum(idx * torch.as_tensor(strides, dtype=idx.dtype, device=idx.device)[None, :], dim=1)

    def _apply(diag_fun):
        base = diag_fun(sigma2)
        coef = diag_fun(lam_p + sigma2) - base  # (p,)

        def op(v: torch.Tensor) -> torch.Tensor:
            squeeze = v.ndim == 1
            vv = v[:, None] if squeeze else v
            z = kron_matvec_fast(QT, vv, precision="highest")  # eigen basis
            u = torch.zeros((m, vv.shape[1]), dtype=z.dtype, device=z.device)
            u[flat] = z[flat] * coef[:, None]
            out = base * vv + kron_matvec_fast(Qs, u, precision="highest")
            return out[:, 0] if squeeze else out

        return op

    logdet_M = torch.sum(torch.log(lam_p + sigma2)) + (m - p) * torch.log(sigma2)
    return _apply(lambda s: 1.0 / s), _apply(lambda s: 1.0 / torch.sqrt(s)), logdet_M
