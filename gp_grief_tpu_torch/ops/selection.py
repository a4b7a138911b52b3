"""Selection (subset-of-identity) operators as index vectors.

Counterpart of ``gp_grief_tpu.ops.selection``.  A selection matrix ``S``
``(k, m)`` is an integer index vector: ``S @ x`` is a row gather and
``Sᵀ @ u`` a scatter-add.  The scatter-add is deterministic on the card as on
the CPU: ``index_add_`` on CUDA sums repeated indices with atomics, in an
order that varies from run to run, so the rows are sorted stably by index
and each run of equal indices is reduced on its own (``segment_reduce``, no
atomics), then written once.
"""

from __future__ import annotations

import torch

__all__ = ["select_rows", "select_rows_t", "selection_expand"]


def select_rows(indices: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``S @ x``: the rows ``x[indices]``; ``x`` ``(m, ...)`` → ``(k, ...)``."""
    return torch.index_select(x, 0, torch.as_tensor(indices, device=x.device).to(torch.int64))


def select_rows_t(indices: torch.Tensor, u: torch.Tensor, m: int) -> torch.Tensor:
    """``Sᵀ @ u``: rows of ``u`` ``(k, ...)`` summed into ``m`` rows, repeated
    indices summed deterministically."""
    indices = torch.as_tensor(indices, device=u.device).to(torch.int64)
    out = torch.zeros((int(m),) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
    if indices.numel() == 0:
        return out
    order = torch.argsort(indices, stable=True)
    rows, counts = torch.unique_consecutive(indices[order], return_counts=True)
    out[rows] = torch.segment_reduce(torch.index_select(u, 0, order), "sum", lengths=counts, axis=0)
    return out


def selection_expand(indices: torch.Tensor, m: int) -> torch.Tensor:
    """Dense float64 ``S`` ``(k, m)``: a test oracle."""
    indices = torch.as_tensor(indices).to(torch.int64)
    return torch.eye(int(m), dtype=torch.float64, device=indices.device)[indices]
