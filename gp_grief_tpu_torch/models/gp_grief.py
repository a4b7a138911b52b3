"""GP-GRIEF model: O(n·p + p³) exact inference with grid eigenfunctions.

Counterpart of ``gp_grief_tpu.models.gp_grief`` (closed-form surface).  The
kernel is ``k(x,z) = Σ_j w_j φ_j(x) φ_j(z)`` with the GRIEF basis
(``kernels/grief.py``); NLML and prediction use the inversion and determinant
lemmas (``models/base.py``), so after the O(n·p²) reductions each NLML
evaluation is O(p³).

Two training regimes:

* ``reweight_eig_funs`` (default): train ``log_w`` and the noise against a
  fixed basis whose ``ΦᵀΦ``/``Φᵀy`` are cached.
* ``opt_kernel_params``: also train the base-kernel hyperparameters; the whole
  basis stack (eigh → top-p → Φ → reductions) is rebuilt inside the objective
  and differentiated by autograd.

The model lives on the device and dtype given at construction (training data,
grid and cached statistics are plain tensors there, not buffers, so
``state_dict()`` holds exactly the JAX package's parameter leaves).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from gp_grief_tpu_torch.grid import InducingGrid
from gp_grief_tpu_torch.kernels.base import inverse_positive
from gp_grief_tpu_torch.kernels.grief import GriefBasis, build_basis, phi, stack_kernels
from gp_grief_tpu_torch.kernels.stationary import Stationary
from gp_grief_tpu_torch.models.base import (
    BaseModel,
    BasisStats,
    basis_nlml,
    basis_posterior,
    check_xy,
    resolve_device,
)

__all__ = ["GPGriefModel", "init_grief_state"]


def _resolve_dtype(x, dtype) -> torch.dtype:
    if dtype is not None:
        return dtype
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.dtype
    return torch.float32 if np.asarray(x).dtype == np.float32 else torch.float64


def _to_tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def init_grief_state(x, y, kern_list, grid, n_eigs, noise_var, mbar, dtype=None, device=None):
    """Constructor plumbing shared by GRIEF-family models: coerce data,
    default the grid, clamp ``n_eigs`` to the lattice, copy the kernel list
    into d independent modules of the working dtype/device, and make the
    initial parameters.  Returns ``(x, y, grid, xg, n_eigs, dims, params)``
    with ``params = {"kernels": [...], "log_noise": ..., "log_w": ...}``."""
    dtype = _resolve_dtype(x, dtype)
    device = resolve_device(x, device)
    x, y = check_xy(_to_tensor(x, dtype, device), _to_tensor(y, dtype, device))
    if grid is None:
        grid = InducingGrid.build(x.cpu().numpy(), mbar=mbar)
    xg = tuple(_to_tensor(g, dtype, device) for g in grid.xg)
    n_eigs = int(n_eigs)
    if grid.log10_num_virtual < 18:  # lattice countable in int64
        n_eigs = min(n_eigs, int(np.prod(grid.grid_shape)))
    dims = getattr(grid, "dims", None)
    if dims is not None and all(len(g) == 1 for g in dims):
        dims = None
    kerns = list(kern_list) if isinstance(kern_list, (list, tuple)) else [kern_list] * grid.grid_dim
    if len(kerns) != grid.grid_dim:
        raise ValueError(f"need {grid.grid_dim} kernels, got {len(kerns)}")
    # One deep copy per dimension: a shared (radial) kernel becomes d
    # independent parameter sets, as the JAX pytree's d leaves do.
    kerns = [copy.deepcopy(k).to(dtype=dtype, device=device) for k in kerns]
    params = {
        "kernels": kerns,
        "log_noise": inverse_positive(noise_var, dtype=dtype, device=device),
        "log_w": torch.zeros((n_eigs,), dtype=dtype, device=device),
    }
    return x, y, grid, xg, n_eigs, dims, params


class GPGriefModel(BaseModel):
    """``GPGriefModel(x, y, kern_list, grid, n_eigs=, noise_var=, ..., dtype=, device=)``.

    ``dtype`` defaults to ``x``'s floating type (float32 arrays stay float32,
    anything else becomes float64); ``device`` to ``x``'s device for a tensor
    ``x``, else the card (``device="cpu"`` for the CPU; without a CUDA device
    and without ``device`` the constructor raises).
    """

    # Row-chunk size for the O(n·p²) reductions: bounds the live Φ block at
    # chunk·p values regardless of n.
    stats_chunk: int = 131072

    # Φ assembly: "auto" takes kernel K1 on CUDA tensors where it applies
    # (kernels/grief.py:phi).
    phi_impl: str = "auto"

    def __init__(
        self,
        x,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        grid: Optional[InducingGrid] = None,
        *,
        n_eigs: int = 100,
        noise_var: float = 1.0,
        reweight_eig_funs: bool = True,
        opt_kernel_params: bool = False,
        dim_noise_var: float = 1e-12,
        mbar: int = 10,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        (x, y, self.grid, self.xg, self.n_eigs, self.dims, params) = init_grief_state(
            x, y, kern_list, grid, n_eigs, noise_var, mbar, dtype, device
        )
        if x.is_cuda:
            # The JAX reference runs its Φ and basis dots at HIGHEST; TF32
            # keeps ~3 decimal digits, so float32 products stay full float32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.x, self.y = x, y
        self.kernels = nn.ModuleList(params["kernels"])
        self.log_noise = nn.Parameter(params["log_noise"])
        self.log_w = nn.Parameter(params["log_w"])
        self.reweight_eig_funs = bool(reweight_eig_funs)
        self.opt_kernel_params = bool(opt_kernel_params)
        self.dim_noise_var = float(dim_noise_var)
        if not self.opt_kernel_params:
            self._refresh_cache()

    # -- basis plumbing ------------------------------------------------------

    def _build(self) -> GriefBasis:
        return build_basis(self.kernels, self.xg, self.n_eigs, dim_noise_var=self.dim_noise_var)

    def _stats_from(self, basis: GriefBasis, impl: Optional[str] = None) -> BasisStats:
        """``ΦᵀΦ``, ``Φᵀy`` and ``yᵀy`` at the current kernels, over row
        chunks of ``stats_chunk`` when ``n`` exceeds it.  The products run in
        full float32/float64 (the TPU ran them at bf16 DEFAULT)."""
        if impl is None:
            impl = self.phi_impl
        n = self.x.shape[0]
        C = v = yy = 0.0
        for s in range(0, n, self.stats_chunk):
            xk, yk = self.x[s : s + self.stats_chunk], self.y[s : s + self.stats_chunk]
            Phik = phi(basis, self.kernels, self.xg, xk, dims=self.dims, impl=impl)
            C = C + Phik.T @ Phik
            v = v + Phik.T @ yk
            yy = yy + torch.dot(yk, yk)
        return BasisStats(C=C, v=v, yy=yy, n=n)

    def _kern_fingerprint(self) -> bytes:
        """Value fingerprint of the kernel hyperparameters (the only
        parameters the cached basis/stats depend on): catches replacement and
        in-place mutation alike, and stays equal through reweight-only
        training."""
        flat = torch.cat([p.detach().reshape(-1) for p in self.kernels.parameters()])
        return flat.cpu().numpy().tobytes()

    def _refresh_cache(self) -> None:
        with torch.no_grad():
            self._basis = self._build()
            self._stats = self._stats_from(self._basis)
        self._cached_for = self._kern_fingerprint()

    def _ensure_cache(self) -> None:
        """Rebuild the cached basis+stats if missing or stale."""
        if not hasattr(self, "_basis") or self._cached_for != self._kern_fingerprint():
            self._refresh_cache()

    def log_likelihood(self) -> float:
        if not self.opt_kernel_params:
            self._ensure_cache()
        return super().log_likelihood()

    def refresh_basis(self) -> None:
        """Rebuild the eigenbasis and cached statistics at the current
        hyperparameters (e.g. after loading parameters or switching
        ``opt_kernel_params`` phases)."""
        self._refresh_cache()

    # -- NLML ---------------------------------------------------------------

    def _phi_impl_grad(self) -> str:
        """Φ path for differentiated assemblies (the ``opt_kernel_params``
        objective): the batched einsum when the dimensions stack — K1's
        backward is the plain version anyway — else ``phi_impl``."""
        if self.phi_impl != "auto":
            return self.phi_impl
        return "batched" if stack_kernels(self.kernels, self.xg, self.dims) is not None else "auto"

    def _loss(self) -> torch.Tensor:
        log_w = self.log_w if self.reweight_eig_funs else self.log_w.detach()
        if self.opt_kernel_params:
            stats = self._stats_from(self._build(), impl=self._phi_impl_grad())
        else:
            stats = self._stats
        return basis_nlml(stats, log_w, self.log_noise)

    def optimize(self, **kwargs):
        if not self.opt_kernel_params:
            # Reweight mode trains against the cached stats; rebuild them if
            # the kernels changed since, so training and predict share a basis.
            self._ensure_cache()
        res = super().optimize(**kwargs)
        if self.opt_kernel_params:
            self._refresh_cache()  # re-anchor the cached basis at the optimum
        return res

    def kernel_matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``(K̃ + σ²I) v = Φ W Φᵀ v + σ² v`` in O(n·p); ``v``: ``(n,)`` or ``(n, B)``."""
        self._ensure_cache()
        with torch.no_grad():
            Phi = phi(self._basis, self.kernels, self.xg, self.x, dims=self.dims, impl=self.phi_impl)
            w = torch.exp(self.log_w)
            sigma2 = torch.exp(self.log_noise)
            vv = v[:, None] if v.ndim == 1 else v
            out = Phi @ (w[:, None] * (Phi.T @ vv)) + sigma2 * vv
        return out[:, 0] if v.ndim == 1 else out

    # -- prediction ----------------------------------------------------------

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False):
        """Posterior mean (O(n*·p)) and, with ``compute_var``, variance
        (O(n*·p²)) at ``x_new``, from the weight-space posterior.  Returns
        tensors on the model's device."""
        x_new = _to_tensor(x_new, self.x.dtype, self.x.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        self._ensure_cache()
        with torch.no_grad():
            L, theta = basis_posterior(self._stats, self.log_w, self.log_noise)
            Phis = phi(self._basis, self.kernels, self.xg, x_new, dims=self.dims, impl=self.phi_impl)
            mean = Phis @ theta
            if not compute_var:
                return mean
            sigma2 = torch.exp(self.log_noise)
            A = torch.linalg.solve_triangular(L, Phis.T, upper=False)
            var = sigma2 * torch.sum(A**2, dim=0)
            if include_noise:
                var = var + sigma2
        return mean, var
