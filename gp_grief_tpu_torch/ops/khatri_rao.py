"""Row-partitioned Khatri-Rao products and row/col-selected Kronecker products.

Counterpart of ``gp_grief_tpu.ops.khatri_rao``.  A row-partitioned
Khatri-Rao matrix has row ``i`` equal to ``⊗_d A_d[i, :]`` with each ``A_d``
``(n, m_d)``: the cross-covariance between ``n`` scattered points and a
product grid.  It stays a tuple of per-dimension arrays, and its matvec is a
chain of batched contractions, ``O(n · Σ m_d)`` work per column instead of
``O(n · Π m_d)``.

The row-col selected form is the GRIEF basis before expansion:
``Φ[i, j] = Π_d B_d[i, idx[j, d]]`` with ``B_d`` ``(n, m_d)`` and an index
table ``idx`` ``(p, d)``; its columns are gathered by ``index_select``
(deterministic on the card; the model path assembles Φ with kernel K1).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["kr_expand", "kr_matvec", "kr_rmatvec", "rowcol_kr_expand", "rowcol_kr_matvec", "rowcol_kr_rmatvec"]


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


def kr_rmatvec(A_list: Sequence[torch.Tensor], u: torch.Tensor) -> torch.Tensor:
    """``KR(A)ᵀ @ u``: ``(n,)`` or ``(n, B)`` → ``(Π m_d,)`` or ``(Π m_d, B)``.

    Builds ``t[i, j_1..j_k, b] = u[i, b] · Π_{d<k} A_d[i, j_d]`` over all
    but the last dimension, then contracts the row index against the last
    factor in one product, so the peak intermediate is ``n · Π m_d / m_d · B``."""
    squeeze = u.ndim == 1
    if squeeze:
        u = u[:, None]
    t = u[:, None, :] * A_list[0][:, :, None]  # (n, m_1, B)
    for A in A_list[1:-1]:
        n, B = t.shape[0], t.shape[-1]
        t = (t.reshape(n, -1, 1, B) * A[:, None, :, None]).reshape(n, -1, B)
    if len(A_list) > 1:
        out = torch.einsum("nrb,nm->rmb", t, A_list[-1]).reshape(-1, t.shape[-1])
    else:
        out = torch.sum(t, dim=0)
    return out[:, 0] if squeeze else out


def _rowcol_columns(B_list: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    idx = idx.to(device=B_list[0].device, dtype=torch.int64)
    out = torch.ones((B_list[0].shape[0], idx.shape[0]), dtype=B_list[0].dtype, device=B_list[0].device)
    for d, Bd in enumerate(B_list):
        out = out * torch.index_select(Bd, 1, idx[:, d])
    return out


def rowcol_kr_expand(B_list: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """Dense ``(n, p)`` ``Φ[i, j] = Π_d B_d[i, idx[j, d]]``, ``O(n·p·d)``."""
    return _rowcol_columns(B_list, idx)


def rowcol_kr_matvec(B_list: Sequence[torch.Tensor], idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Φ @ v`` for ``v`` ``(p,)`` or ``(p, B)``."""
    return _rowcol_columns(B_list, idx) @ v


def rowcol_kr_rmatvec(B_list: Sequence[torch.Tensor], idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``Φᵀ @ u`` for ``u`` ``(n,)`` or ``(n, B)``."""
    return _rowcol_columns(B_list, idx).T @ u
