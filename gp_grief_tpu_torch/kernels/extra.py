"""More kernels: rational quadratic, periodic, cosine, white, constant,
linear, and the ``Sum`` / ``Product`` combinators.

Counterpart of ``gp_grief_tpu.kernels.extra``.  Each kernel is an
``nn.Module`` whose ``nn.Parameter``s carry the JAX leaf names
(``log_lengthscale``, ``log_variance``, ``log_alpha``, ``log_period``,
``log_variances``; ``k1`` / ``k2`` for the combinators), registered in the JAX
dataclass's field order, which ``jax_fields`` states, so flat parameter
vectors line up between the two packages.  Each is callable as
``k(x, z=None) -> Gram``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gp_grief_tpu_torch.kernels.base import inverse_positive, positive
from gp_grief_tpu_torch.kernels.stationary import _sq_dist

__all__ = [
    "RatQuad", "Periodic", "Cosine", "White", "Constant", "Linear", "Sum", "Product", "make_ratquad",
    "make_periodic",
]


def _prep(x: torch.Tensor, z: Optional[torch.Tensor]):
    if x.ndim == 1:
        x = x[:, None]
    same = z is None
    z = x if same else (z[:, None] if z.ndim == 1 else z)
    return x, z, same


class _Kernel(nn.Module):
    """Takes ``jax_fields`` by position or name (the JAX dataclass's
    constructor) and registers them as parameters, in that order."""

    jax_fields: tuple = ()

    def __init__(self, *values, **named):
        super().__init__()
        given = {**dict(zip(self.jax_fields, values)), **named}
        if len(values) > len(self.jax_fields) or set(given) != set(self.jax_fields):
            raise TypeError(f"{type(self).__name__} takes {self.jax_fields}")
        for name in self.jax_fields:
            setattr(self, name, nn.Parameter(torch.as_tensor(given[name])))


class RatQuad(_Kernel):
    """Rational quadratic ``σ² (1 + r²/(2αℓ²))^{-α}``."""

    jax_fields = ("log_lengthscale", "log_variance", "log_alpha")

    def forward(self, x, z=None):
        x, z, same = _prep(x, z)
        ls = torch.broadcast_to(positive(self.log_lengthscale), (x.shape[-1],))
        r2 = _sq_dist(x / ls, z / ls, same)
        alpha = positive(self.log_alpha)
        return positive(self.log_variance) * (1.0 + r2 / (2.0 * alpha)) ** (-alpha)


class Periodic(_Kernel):
    """ExpSineSquared ``σ² exp(−2 sin²(π r / T) / ℓ²)`` on the first input column."""

    jax_fields = ("log_lengthscale", "log_variance", "log_period")

    def forward(self, x, z=None):
        x, z, _ = _prep(x, z)
        r = torch.abs(x[:, :1] - z[:, :1].T)
        s = torch.sin(math.pi * r / positive(self.log_period)) / positive(self.log_lengthscale)
        return positive(self.log_variance) * torch.exp(-2.0 * s * s)


class Cosine(_Kernel):
    """``σ² cos(2π r / T)`` on the first input column."""

    jax_fields = ("log_variance", "log_period")

    def forward(self, x, z=None):
        x, z, _ = _prep(x, z)
        r = x[:, :1] - z[:, :1].T
        return positive(self.log_variance) * torch.cos(2.0 * math.pi * r / positive(self.log_period))


class White(_Kernel):
    """White noise ``σ²·1[x == z]``: the identity on one input set, the exact
    coincidence indicator across two (the matrix-free Gram evaluates
    ``k(x_block, x)``, where a blanket zero would drop the diagonal that
    ``cov_diag`` keeps).  The per-column equality product keeps the peak
    intermediate at one ``(n, m)`` block."""

    jax_fields = ("log_variance",)

    def forward(self, x, z=None):
        x, z, same = _prep(x, z)
        if same:
            return positive(self.log_variance) * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        eq = torch.ones((x.shape[0], z.shape[0]), dtype=torch.bool, device=x.device)
        for k in range(x.shape[1]):
            eq = eq & (x[:, k, None] == z[None, :, k])
        return positive(self.log_variance) * eq.to(x.dtype)


class Constant(_Kernel):
    """Bias ``σ² · 1``."""

    jax_fields = ("log_variance",)

    def forward(self, x, z=None):
        x, z, _ = _prep(x, z)
        return positive(self.log_variance) * torch.ones((x.shape[0], z.shape[0]), dtype=x.dtype, device=x.device)


class Linear(_Kernel):
    """Dot product ``Σ_d σ_d² x_d z_d`` (``log_variances``: ``(d,)`` or scalar)."""

    jax_fields = ("log_variances",)

    def forward(self, x, z=None):
        x, z, _ = _prep(x, z)
        w = torch.broadcast_to(positive(self.log_variances), (x.shape[-1],))
        return (x * w) @ z.T


class Sum(nn.Module):
    """``k₁ + k₂`` (nest for more terms)."""

    jax_fields = ("k1", "k2")

    def __init__(self, k1: nn.Module, k2: nn.Module):
        super().__init__()
        self.k1, self.k2 = k1, k2

    def forward(self, x, z=None):
        return self.k1(x, z) + self.k2(x, z)


class Product(nn.Module):
    """``k₁ · k₂`` (elementwise)."""

    jax_fields = ("k1", "k2")

    def __init__(self, k1: nn.Module, k2: nn.Module):
        super().__init__()
        self.k1, self.k2 = k1, k2

    def forward(self, x, z=None):
        return self.k1(x, z) * self.k2(x, z)


def make_ratquad(lengthscale=1.0, variance=1.0, alpha=1.0, input_dim=None, *, dtype=torch.float64,
                 device=None) -> RatQuad:
    """Factory mirroring ``gp_grief_tpu.kernels.make_ratquad``; ``input_dim``
    with a scalar lengthscale makes it a per-dimension vector."""
    ls = torch.as_tensor(lengthscale, dtype=torch.float64)
    if input_dim is not None and ls.ndim == 0:
        ls = ls.expand(input_dim).clone()
    return RatQuad(*(inverse_positive(v, dtype=dtype, device=device) for v in (ls, variance, alpha)))


def make_periodic(lengthscale=1.0, variance=1.0, period=1.0, *, dtype=torch.float64, device=None) -> Periodic:
    """Factory mirroring ``gp_grief_tpu.kernels.make_periodic``."""
    return Periodic(*(inverse_positive(v, dtype=dtype, device=device) for v in (lengthscale, variance, period)))
