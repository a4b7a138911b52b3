"""Product kernels over Cartesian grids → Kronecker factor lists.

Counterpart of ``gp_grief_tpu.kernels.grid``: a product kernel
``k(x, z) = Π_d k_d(x_d, z_d)`` on a product grid gives ``K_UU = ⊗_d K_d``,
here a tuple of per-dimension Gram matrices.  Passing one kernel (not a list)
shares it across all dimensions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from gp_grief_tpu_torch.kernels.stationary import Stationary

__all__ = ["cov_grid", "cross_cov_grid", "product_cov"]

KernList = Sequence[Stationary]


def _kern_for_dim(kernels, d):
    if not isinstance(kernels, (list, tuple, nn.ModuleList)):
        return kernels
    return kernels[d]


def cov_grid(
    kernels: Union[Stationary, KernList],
    xg: Sequence[torch.Tensor],
    *,
    dim_noise_var: float = 0.0,
) -> Tuple[torch.Tensor, ...]:
    """Per-dimension Gram factors of ``K_UU = ⊗_d K_d`` on grid ``xg``
    (``xg[d]``: ``(m_d, s_d)``), each plus ``dim_noise_var·I``."""
    out = []
    for d, g in enumerate(xg):
        K = _kern_for_dim(kernels, d)(g)
        if dim_noise_var:
            K = K + dim_noise_var * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
        out.append(K)
    return tuple(out)


def cross_cov_grid(
    kernels: Union[Stationary, KernList],
    x: torch.Tensor,
    xg: Sequence[torch.Tensor],
    dims: Optional[Sequence[Sequence[int]]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Per-dimension cross-covariances ``K_xU_d = k_d(x[:, dims_d], xg[d])``,
    each ``(n, m_d)``.  ``dims[d]`` lists the input columns of grid dimension
    ``d`` (default: dimension ``d`` ↦ column ``d``)."""
    if x.ndim == 1:
        x = x[:, None]
    out = []
    for d, g in enumerate(xg):
        cols = list(dims[d]) if dims is not None else [d]
        out.append(_kern_for_dim(kernels, d)(x[:, cols], g))
    return tuple(out)


def product_cov(
    kernels: Union[Stationary, KernList],
    x: torch.Tensor,
    z: Optional[torch.Tensor] = None,
    *,
    n_dims: Optional[int] = None,
) -> torch.Tensor:
    """Dense product-kernel Gram ``Π_d k_d(x_d, z_d)`` for scattered inputs."""
    if x.ndim == 1:
        x = x[:, None]
    if z is not None and z.ndim == 1:
        z = z[:, None]
    d = x.shape[1] if n_dims is None else n_dims
    out = None
    for dd in range(d):
        zd = None if z is None else z[:, dd : dd + 1]
        Kd = _kern_for_dim(kernels, dd)(x[:, dd : dd + 1], zd)
        out = Kd if out is None else out * Kd
    return out
