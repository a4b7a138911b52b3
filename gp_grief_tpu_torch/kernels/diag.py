"""Diagonal-only kernel evaluation: ``k(x_i, x_i)`` without the (n, n) Gram.

Counterpart of ``gp_grief_tpu.kernels.diag.cov_diag`` for the kernels the
port has: a stationary kernel's diagonal is its variance, and a per-dimension
list multiplies its members' diagonals.  The JAX package's ``extra`` kernels
(linear, periodic, sums, products, ...) are not ported yet; any other kernel
raises, naming it.
"""

from __future__ import annotations

import torch
from torch import nn

from gp_grief_tpu_torch.kernels.base import positive
from gp_grief_tpu_torch.kernels.stationary import Stationary

__all__ = ["cov_diag"]


def cov_diag(kern, x: torch.Tensor, dims=None) -> torch.Tensor:
    """``diag k(x, x)`` for a stationary kernel or a per-dimension kernel list.

    ``dims[d]`` selects the input columns of list member ``d`` (grouped grid
    dimensions; default: member ``d`` ↦ column ``d``)."""
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    if isinstance(kern, (list, tuple, nn.ModuleList)):
        out = torch.ones((n,), dtype=x.dtype, device=x.device)
        for d, k in enumerate(kern):
            cols = x[:, list(dims[d])] if dims is not None else x[:, d : d + 1]
            out = out * cov_diag(k, cols)
        return out
    if isinstance(kern, Stationary):
        return positive(kern.log_variance).to(x.dtype).expand(n)
    raise NotImplementedError(f"cov_diag: kernel {type(kern).__name__} is not ported yet")
