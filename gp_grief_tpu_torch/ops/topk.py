"""Top-p eigenvalue selection for Kronecker products, in log-space.

Counterpart of ``gp_grief_tpu.ops.topk``: the ``p`` largest sums
``Σ_d log λ_d[i_d]`` by an exact incremental fold (keep the top-p partial sums
over dims ``1..k``; folding in dim ``k+1`` forms the ``p × m_{k+1}`` outer
sums and re-selects the top p).  Cost ``O(Σ_d p·m_d)``.

Ties: ``lax.top_k`` returns equal values lower index first, while
``torch.topk`` promises no order.  The selection here is a *stable*
descending sort, which keeps equal values in index order — the same
tie-break as the JAX package (equal per-dimension kernels on equal grids tie
exactly).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

__all__ = ["top_p_kron_eigs"]


def _top(vals: torch.Tensor, k: int, quantum=None) -> Tuple[torch.Tensor, torch.Tensor]:
    if quantum is None:
        s, i = torch.sort(vals, descending=True, stable=True)
        return s[:k], i[:k]
    i = torch.sort(torch.round(vals / quantum), descending=True, stable=True).indices[:k]
    return vals[i], i


def top_p_kron_eigs(
    lams: Sequence[torch.Tensor],
    p: int,
    *,
    min_eig: float | None = None,
    tie_quantum: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the ``p`` largest Kronecker eigenvalue products in log-space.

    Returns ``(log_lam, idx)``: ``log_lam`` ``(p,)`` descending, and ``idx``
    ``(p, d)`` int64 per-dimension eigenvalue indices of each product.

    ``tie_quantum`` (the port's addition; SKI's deflation uses it) orders the
    log-sums by their value rounded to that quantum, ties by index.  Equal
    kernels on equal grids make groups of exactly tied products, and a
    selection that cuts through one would otherwise keep the members whose
    sums happen to round highest, which differs between eigensolvers.
    """
    d = len(lams)
    dtype = functools.reduce(torch.promote_types, [lam.dtype for lam in lams])
    device = lams[0].device
    if min_eig is None:
        min_eig = torch.finfo(dtype).tiny

    log0 = torch.log(torch.clamp(lams[0].to(dtype), min=min_eig))
    k0 = min(p, int(log0.shape[0]))
    vals, i0 = _top(log0, k0, tie_quantum)
    sums = torch.cat([vals, torch.full((p - k0,), -torch.inf, dtype=dtype, device=device)])
    idx = torch.zeros((p, d), dtype=torch.int64, device=device)
    idx[:k0, 0] = i0

    for dd in range(1, d):
        log_d = torch.log(torch.clamp(lams[dd].to(dtype), min=min_eig))
        m_d = int(log_d.shape[0])
        # -inf prefixes (lattice smaller than p) stay -inf and sort last.
        flat = (sums[:, None] + log_d[None, :]).reshape(-1)
        sums, flat_i = _top(flat, p, tie_quantum)
        idx = idx[flat_i // m_d]
        idx[:, dd] = flat_i % m_d
    return sums, idx
