"""Exact GP regression: the parity oracle and small-n model.

Counterpart of ``gp_grief_tpu.models.gp_regression``'s dense path: a
zero-mean GP with Gaussian noise, the NLML by a Cholesky factor of the
``(n, n)`` Gram, the predictive mean and variance by triangular solves.  The
iterative path (``solver="iterative"``: CG + SLQ on a row-chunked
matrix-free Gram) is not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import copy
import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from gp_grief_tpu_torch.kernels.base import inverse_positive
from gp_grief_tpu_torch.kernels.diag import cov_diag
from gp_grief_tpu_torch.kernels.grid import product_cov
from gp_grief_tpu_torch.kernels.stationary import Stationary
from gp_grief_tpu_torch.models.base import BaseModel, check_xy, resolve_device
from gp_grief_tpu_torch.models.gp_grief import _resolve_dtype, _to_tensor
from gp_grief_tpu_torch.ops.solve import cholesky, logdet_from_chol

__all__ = ["GPRegression", "gp_nlml"]

KernelLike = Union[Stationary, Sequence[Stationary]]

_ITERATIVE = "is not ported yet (ROADMAP Queue 1 item 6, GPRegression's iterative path)"


def _is_list(kernels) -> bool:
    return isinstance(kernels, (list, tuple, nn.ModuleList))


def _cov_any(kernels: KernelLike, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram of one kernel, or of a product of per-dimension kernels (a list:
    member ``d`` on column ``d``)."""
    if not _is_list(kernels):
        return kernels(x, z)
    return product_cov(list(kernels), x, z)


def _auto_matvec_chunk(n: int) -> int:
    """The row-block size the JAX package picks for its matrix-free Gram
    matvec: ~2^28 block elements, at least 128 rows."""
    return int(max(128, min(8192, (1 << 28) // max(n, 1))))


def gp_nlml(kernels: KernelLike, log_noise: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact NLML ``½ yᵀK̃⁻¹y + ½ log|K̃| + (n/2) log 2π``, ``K̃ = K + σ²I``.
    A failed factor gives NaN (``ops.solve.cholesky``), which ``fit``
    rejects."""
    n = x.shape[0]
    K = _cov_any(kernels, x)
    sigma2 = torch.exp(log_noise)
    L = cholesky(K + sigma2 * torch.eye(n, dtype=K.dtype, device=K.device))
    a = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return 0.5 * (torch.sum(a**2) + logdet_from_chol(L) + n * math.log(2.0 * math.pi))


class GPRegression(BaseModel):
    """``GPRegression(x, y, kernel, noise_var=1.0, *, solver="cholesky", ...,
    dtype=, device=)`` — the JAX package's constructor, plus ``dtype`` and
    ``device`` as the other models take them.

    ``kernel`` is one kernel or a per-dimension list; the parameters are
    ``kernel.*`` (``kernel.0.*``, … for a list) and ``log_noise``, in the
    JAX package's flat-vector order.  ``solver="iterative"``, or a
    ``matvec_chunk > 0``, raises ``NotImplementedError``; the iterative
    options (``num_probes`` … ``mixed16``, ``key``) are kept as given.
    """

    def __init__(
        self,
        x,
        y,
        kernel: KernelLike,
        noise_var: float = 1.0,
        *,
        solver: str = "cholesky",
        num_probes: int = 32,
        lanczos_iters: int = 64,
        cg_tol: float = 1e-8,
        cg_iters: int = 1000,
        precond_rank: int = 0,
        matvec_chunk="auto",
        mixed16: bool = False,
        key=None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if solver not in ("cholesky", "iterative"):
            raise ValueError("solver must be 'cholesky' or 'iterative'")
        if solver == "iterative":
            raise NotImplementedError(f"GPRegression(solver='iterative') {_ITERATIVE}")
        if matvec_chunk != "auto" and int(matvec_chunk) > 0:
            raise NotImplementedError(f"GPRegression(matvec_chunk > 0), the matrix-free Gram, {_ITERATIVE}")
        dtype = _resolve_dtype(x, dtype)
        device = resolve_device(x, device)
        self.x, self.y = check_xy(_to_tensor(x, dtype, device), _to_tensor(y, dtype, device))
        self.solver = solver
        n = int(self.x.shape[0])
        if matvec_chunk == "auto":
            matvec_chunk = 0 if n <= 32768 else _auto_matvec_chunk(n)
        self._iter_opts = dict(
            num_probes=num_probes, lanczos_iters=lanczos_iters, cg_tol=cg_tol, cg_iters=cg_iters,
            precond_rank=precond_rank, matvec_chunk=int(matvec_chunk), mixed16=bool(mixed16),
        )
        self._key = key
        if _is_list(kernel):
            self.kernel = nn.ModuleList([copy.deepcopy(k).to(dtype=dtype, device=device) for k in kernel])
        else:
            self.kernel = copy.deepcopy(kernel).to(dtype=dtype, device=device)
        self.log_noise = nn.Parameter(inverse_positive(noise_var, dtype=dtype, device=device))

    @property
    def noise_var(self) -> float:
        return float(torch.exp(self.log_noise.detach()))

    def _loss(self) -> torch.Tensor:
        return gp_nlml(self.kernel, self.log_noise, self.x, self.y)

    def _kern_fingerprint(self):
        """Value fingerprint of the hyperparameters, one ``bytes`` per leaf."""
        return tuple(p.detach().cpu().numpy().tobytes() for _, p in self._leaves())

    def _factor(self):
        """``(L, α)`` of ``K̃ = LLᵀ``, ``α = K̃⁻¹y``, cached per
        hyperparameter values, so repeated predictions at one optimum
        factorize once."""
        key = self._kern_fingerprint()
        if getattr(self, "_factor_key", None) != key:
            with torch.no_grad():
                n = self.x.shape[0]
                K = _cov_any(self.kernel, self.x)
                L = cholesky(K + torch.exp(self.log_noise) * torch.eye(n, dtype=K.dtype, device=K.device))
                a = torch.linalg.solve_triangular(L, self.y[:, None], upper=False)
                alpha = torch.linalg.solve_triangular(L.T, a, upper=True)[:, 0]
            self._factor_cache, self._factor_key = (L, alpha), key
        return self._factor_cache

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False, chunk: int = 0):
        """Predictive mean ``K_*X K̃⁻¹y`` and, with ``compute_var``, the
        variance ``k(x*, x*) − ‖L⁻¹K_X*‖²`` clamped at 0 (plus σ² with
        ``include_noise``).  ``chunk`` is the JAX package's test-chunk size of
        its matrix-free predict and does nothing on the dense path.  Returns
        tensors on the model's device."""
        del chunk
        x_new = _to_tensor(x_new, self.x.dtype, self.x.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        L, alpha = self._factor()
        with torch.no_grad():
            Ks = _cov_any(self.kernel, x_new, self.x)  # (n*, n)
            mean = Ks @ alpha
            if not compute_var:
                return mean
            A = torch.linalg.solve_triangular(L, Ks.T, upper=False)  # (n, n*)
            var = torch.clamp_min(cov_diag(self.kernel, x_new) - torch.sum(A**2, dim=0), 0.0)
            if include_noise:
                var = var + torch.exp(self.log_noise)
        return mean, var
