"""Kronecker-product linear algebra on tuples of factor matrices.

Counterpart of ``gp_grief_tpu.ops.kron``.  This slice needs the per-factor
eigendecomposition (the GRIEF basis build) and the dense oracle used by the
tests; the matvec family comes with the Kronecker-matvec slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Factors = Sequence[torch.Tensor]

__all__ = ["kron_expand", "kron_eigh"]


def kron_expand(factors: Factors) -> torch.Tensor:
    """Densify ``K_1 ⊗ ... ⊗ K_d``.  Test/small-scale oracle only."""
    out = factors[0]
    for K in factors[1:]:
        out = torch.kron(out, K)
    return out


def kron_eigh(factors: Factors) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-dimension symmetric eigendecomposition ``K_d = Q_d Λ_d Q_dᵀ``.

    Equal-size factors run as one batched ``eigh``; ragged sizes loop.
    Returns ``(Qs, lams)`` with ascending eigenvalues.
    """
    sizes = {int(f.shape[0]) for f in factors}
    if len(sizes) == 1 and len(factors) > 1:
        lams, Qs = torch.linalg.eigh(torch.stack(list(factors), dim=0))
        return tuple(Qs.unbind(0)), tuple(lams.unbind(0))
    out_Q, out_l = [], []
    for K in factors:
        lam, Q = torch.linalg.eigh(K)
        out_Q.append(Q)
        out_l.append(lam)
    return tuple(out_Q), tuple(out_l)
