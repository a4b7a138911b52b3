"""Diagonal-only kernel evaluation: ``k(x_i, x_i)`` without the (n, n) Gram.

Counterpart of ``gp_grief_tpu.kernels.diag.cov_diag``.  Stationary kernels
and the variance-scaled ``extra`` kernels give a constant, ``Linear`` a
weighted squared norm, ``Sum``/``Product`` and per-dimension lists reduce
recursively.  Any other kernel module is evaluated as 1×1 covariances per
point under ``torch.vmap`` (the JAX package's ``vmap`` fallback), O(n); an
object that is not a kernel module raises, naming it.
"""

from __future__ import annotations

import torch
from torch import nn

from gp_grief_tpu_torch.kernels import extra
from gp_grief_tpu_torch.kernels.base import positive
from gp_grief_tpu_torch.kernels.stationary import Stationary

__all__ = ["cov_diag"]

_CONSTANT_DIAG = (Stationary, extra.RatQuad, extra.Periodic, extra.Cosine, extra.White, extra.Constant)


def cov_diag(kern, x: torch.Tensor, dims=None) -> torch.Tensor:
    """``diag k(x, x)`` for a kernel module or a per-dimension kernel list.

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
    if isinstance(kern, _CONSTANT_DIAG):
        return positive(kern.log_variance).to(x.dtype).expand(n)
    if isinstance(kern, extra.Linear):
        w = torch.broadcast_to(positive(kern.log_variances), (x.shape[-1],))
        return torch.sum(x * x * w, dim=-1)
    if isinstance(kern, extra.Sum):
        return cov_diag(kern.k1, x) + cov_diag(kern.k2, x)
    if isinstance(kern, extra.Product):
        return cov_diag(kern.k1, x) * cov_diag(kern.k2, x)
    if isinstance(kern, nn.Module):
        return torch.vmap(lambda xi: kern(xi[None, :])[0, 0])(x)
    raise NotImplementedError(f"cov_diag: {type(kern).__name__} is not a kernel module of the port")
