"""Covariance kernels: stationary kernels, the ``extra`` kernels and their
combinators, grid product kernels, the GRIEF basis."""

from gp_grief_tpu_torch.kernels.base import inverse_positive, positive
from gp_grief_tpu_torch.kernels.diag import cov_diag
from gp_grief_tpu_torch.kernels.extra import (
    Constant, Cosine, Linear, Periodic, Product, RatQuad, Sum, White, make_periodic, make_ratquad,
)
from gp_grief_tpu_torch.kernels.grid import cov_grid, cross_cov_grid, product_cov
from gp_grief_tpu_torch.kernels.grief import GriefBasis, build_basis, phi, stack_kernels
from gp_grief_tpu_torch.kernels.stationary import KERNEL_KINDS, Stationary, cov, make_kernel

__all__ = [
    "positive", "inverse_positive", "cov_diag", "cov_grid", "cross_cov_grid", "product_cov",
    "GriefBasis", "build_basis", "phi", "stack_kernels",
    "KERNEL_KINDS", "Stationary", "cov", "make_kernel",
    "RatQuad", "Periodic", "Cosine", "White", "Constant", "Linear", "Sum", "Product", "make_ratquad", "make_periodic",
]
