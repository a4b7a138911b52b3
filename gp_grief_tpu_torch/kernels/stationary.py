"""Stationary kernels: RBF and the Matérn family, with ARD lengthscales.

Counterpart of ``gp_grief_tpu.kernels.stationary``.  A kernel is an
``nn.Module`` whose two ``nn.Parameter``s carry the JAX leaf names
(``log_lengthscale``, ``log_variance``); ``kind`` is a plain attribute.

The covariance math is written once over optional leading batch dimensions
(:func:`_cov_scaled`), so the per-dimension call ``k(x, z)`` and the stacked
d-kernel call of the batched Φ assembly (:class:`StackedKernel`, the
counterpart of ``jax.vmap`` over a stacked kernel pytree) share it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from gp_grief_tpu_torch.kernels.base import inverse_positive, positive

__all__ = ["Stationary", "StackedKernel", "make_kernel", "KERNEL_KINDS", "cov"]

KERNEL_KINDS = ("rbf", "exponential", "matern12", "matern32", "matern52")

# GPy-style spelling aliases, as in the JAX package.
_KIND_ALIASES = {
    "expquad": "rbf",
    "squaredexponential": "rbf",
    "sqexp": "rbf",
    "exponential": "exponential",
    "mat12": "matern12",
    "mat32": "matern32",
    "mat52": "matern52",
    "ou": "matern12",
}


class Stationary(nn.Module):
    """A stationary kernel ``σ² g(r/ℓ)``.

    ``log_lengthscale`` has shape ``(input_dim,)`` (ARD) or ``()``
    (isotropic); ``log_variance`` is scalar.
    """

    def __init__(self, log_lengthscale: torch.Tensor, log_variance: torch.Tensor, kind: str):
        super().__init__()
        self.log_lengthscale = nn.Parameter(log_lengthscale)
        self.log_variance = nn.Parameter(log_variance)
        self.kind = kind

    @property
    def lengthscale(self) -> torch.Tensor:
        return positive(self.log_lengthscale)

    @property
    def variance(self) -> torch.Tensor:
        return positive(self.log_variance)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return cov(self, x, z)

    def extra_repr(self) -> str:
        return f"kind={self.kind!r}"


def make_kernel(
    kind: str = "rbf",
    *,
    lengthscale: Union[float, torch.Tensor] = 1.0,
    variance: float = 1.0,
    input_dim: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> Stationary:
    """Factory mirroring ``gp_grief_tpu.make_kernel``.

    ``input_dim`` with a scalar lengthscale broadcasts it to a per-dimension
    (ARD) vector.  Models cast their kernels to the model's dtype and device.
    """
    kind = kind.lower().replace("-", "").replace("_", "")
    kind = _KIND_ALIASES.get(kind, kind)
    if kind not in KERNEL_KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of {KERNEL_KINDS}")
    ls = torch.as_tensor(lengthscale, dtype=torch.float64)
    if input_dim is not None and ls.ndim == 0:
        ls = ls.expand(input_dim).clone()
    return Stationary(
        inverse_positive(ls, dtype=dtype, device=device),
        inverse_positive(variance, dtype=dtype, device=device),
        kind,
    )


_EXACT_DIST_MAX_DIM = 4
# The broadcast regime materializes an (n, m, d) intermediate; past 2^24
# output elements the matmul form wins on memory and time.
_EXACT_DIST_MAX_ELEMS = 1 << 24


def _use_broadcast_dist(n: int, m: int, d: int) -> bool:
    return d <= _EXACT_DIST_MAX_DIM and n * m <= _EXACT_DIST_MAX_ELEMS


def _sq_dist(xs: torch.Tensor, zs: torch.Tensor, same: bool) -> torch.Tensor:
    """Pairwise squared distances of pre-scaled inputs ``(..., n, d)×(..., m, d)
    → (..., n, m)``, in the JAX package's two regimes.

    For ≤4 features and ≤2^24 output elements: exact broadcast differences.
    Otherwise mean-centred ``‖x‖² + ‖z‖² − 2x·zᵀ`` clipped at 0, with values
    below the cancellation noise ``16·eps·(‖x̃‖²+‖z̃‖²)`` snapped to exact zero
    and an exactly-zero diagonal when ``same``.
    """
    if _use_broadcast_dist(xs.shape[-2], zs.shape[-2], xs.shape[-1]):
        d = xs[..., :, None, :] - zs[..., None, :, :]
        return torch.sum(d * d, dim=-1)
    mean = torch.mean(xs, dim=-2, keepdim=True)
    xs = xs - mean
    zs = zs - mean
    x2 = torch.sum(xs * xs, dim=-1)
    z2 = torch.sum(zs * zs, dim=-1)
    cross = xs @ zs.transpose(-1, -2)
    scale = x2[..., :, None] + z2[..., None, :]
    r2 = torch.clamp_min(scale - 2.0 * cross, 0.0)
    eps = torch.finfo(r2.dtype).eps
    r2 = torch.where(r2 <= 16.0 * eps * scale, torch.zeros_like(r2), r2)
    if same:
        n = r2.shape[-1]
        eye = torch.eye(n, dtype=torch.bool, device=r2.device)
        r2 = torch.where(eye, torch.zeros_like(r2), r2)
    return r2


def _cov_scaled(kind: str, var: torch.Tensor, xs: torch.Tensor, zs: torch.Tensor, same: bool):
    """``var · g(r)`` from lengthscale-divided inputs; ``var`` broadcasts
    against the ``(..., n, m)`` output."""
    r2 = _sq_dist(xs, zs, same)
    if kind == "rbf":
        return var * torch.exp(-0.5 * r2)
    # Matérn needs r; sqrt(0) has an infinite gradient, so guard the zeros and
    # restore them after.
    pos = r2 > 0
    r = torch.sqrt(torch.where(pos, r2, torch.ones_like(r2)))
    r = torch.where(pos, r, torch.zeros_like(r))
    if kind in ("exponential", "matern12"):
        return var * torch.exp(-r)
    if kind == "matern32":
        s = 3.0**0.5 * r
        return var * (1.0 + s) * torch.exp(-s)
    if kind == "matern52":
        s = 5.0**0.5 * r
        return var * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(f"unknown kernel kind {kind!r}")


def cov(k: Stationary, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram matrix ``k(x, z)``; ``x``: ``(n, d)``, ``z``: ``(m, d)`` or None."""
    if x.ndim == 1:
        x = x[:, None]
    same = z is None
    if same:
        z = x
    elif z.ndim == 1:
        z = z[:, None]
    ls = torch.broadcast_to(k.lengthscale, (x.shape[-1],))
    return _cov_scaled(k.kind, k.variance, x / ls, z / ls, same)


class StackedKernel:
    """d kernels of one kind stacked along a leading axis (the counterpart of
    the JAX package's stacked ``Stationary`` pytree under ``vmap``).  The
    stacked tensors are views of the per-dimension parameters, so gradients
    flow back to them."""

    def __init__(self, kind: str, log_lengthscale: torch.Tensor, log_variance: torch.Tensor):
        self.kind = kind
        self.log_lengthscale = log_lengthscale  # (d,) or (d, s)
        self.log_variance = log_variance  # (d,)

    def __call__(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Batched Gram ``(d, n, s) × (d, m, s) → (d, n, m)``."""
        same = z is None
        if same:
            z = x
        d = x.shape[0]
        ls = positive(self.log_lengthscale).reshape(d, 1, -1)
        var = positive(self.log_variance).reshape(d, 1, 1)
        return _cov_scaled(self.kind, var, x / ls, z / ls, same)
