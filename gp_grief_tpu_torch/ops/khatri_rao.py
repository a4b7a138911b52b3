"""Row-partitioned Khatri-Rao products.

Counterpart of ``gp_grief_tpu.ops.khatri_rao`` (``kr_expand``, ``kr_matvec``).
A row-partitioned Khatri-Rao matrix has row ``i`` equal to ``⊗_d A_d[i, :]``
with each ``A_d`` ``(n, m_d)``: the cross-covariance between ``n`` scattered
points and a product grid.  It stays a tuple of per-dimension arrays, and its
matvec is a chain of batched contractions, ``O(n · Σ m_d)`` work per column
instead of ``O(n · Π m_d)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["kr_expand", "kr_matvec"]


def kr_expand(A_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """Dense ``(n, Π m_d)`` matrix whose row ``i`` is ``⊗_d A_d[i, :]``."""
    out = A_list[0]
    for A in A_list[1:]:
        n = out.shape[0]
        out = (out[:, :, None] * A[:, None, :]).reshape(n, -1)
    return out


def kr_matvec(A_list: Sequence[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
    """``KR(A_1..A_d) @ v`` for ``v`` ``(Π m_d,)`` or ``(Π m_d, B)``.

    Contracts the last dimension first (one unbatched matmul), then folds the
    remaining dimensions with the row index batched, so the peak intermediate
    is ``n · (Π m_d / m_d) · B`` values rather than ``n · Π m_d · B``.
    """
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    ms = [int(A.shape[1]) for A in A_list]
    x = v.reshape(*ms, v.shape[-1])
    x = torch.einsum("nm,...mb->n...b", A_list[-1], x)
    for A in reversed(A_list[:-1]):
        x = torch.einsum("nm,n...mb->n...b", A, x)
    return x[:, 0] if squeeze else x
