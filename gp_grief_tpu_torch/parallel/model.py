"""ShardedGPGriefModel: the GP-GRIEF model trained data-parallel over ranks.

Counterpart of ``gp_grief_tpu.parallel.model``.  Each rank (one process, one
device) holds its block of the training rows; every NLML evaluation builds
the basis (replicated), computes its rows' ``Φ_k`` (kernel K1 on the card,
``stats_chunk`` rows at a time) and ``psum``-reduces the p×p / p
statistics, then runs the O(p³) core replicated.  Gradients flow through the
collectives (``ops.collectives``), so ``optimize()`` is the same
``fit`` loop as the single-device model's, every rank taking the same steps.
Prediction gathers nothing: it uses the replicated basis and posterior.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from gp_grief_tpu_torch.grid import InducingGrid
from gp_grief_tpu_torch.kernels.grief import build_basis, phi
from gp_grief_tpu_torch.kernels.stationary import Stationary
from gp_grief_tpu_torch.models.base import BaseModel, basis_nlml, basis_posterior, check_xy, resolve_device
from gp_grief_tpu_torch.models.gp_grief import _resolve_dtype, _to_tensor, init_grief_state
from gp_grief_tpu_torch.ops.collectives import axis_size
from gp_grief_tpu_torch.parallel.mesh import data_mesh
from gp_grief_tpu_torch.parallel.sharded import local_basis_stats, local_rows, pad_to_multiple

__all__ = ["ShardedGPGriefModel"]


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class ShardedGPGriefModel(BaseModel):
    """Data-parallel GP-GRIEF (the API of :class:`GPGriefModel`), one rank of it.

    Every rank constructs it from the same full data; it keeps its block of
    the rows, zero-padded to a multiple of the ``axis_name`` axis size with a
    row mask.  The basis is always rebuilt inside the objective
    (``opt_kernel_params`` semantics), so the gradient runs through K1's
    backward on every rank.  ``mesh`` (a ``DeviceMesh``) defaults to a 1-D
    data mesh over every rank of the default process group (a world-1 one in
    a process that has none).  ``dtype``/``device`` as for
    :class:`GPGriefModel`; the parameters carry its leaf names."""

    # Row-chunk size of the reductions: bounds the live Φ block at chunk·p.
    stats_chunk: int = 131072

    def __init__(
        self,
        x,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        grid: Optional[InducingGrid] = None,
        *,
        n_eigs: int = 100,
        noise_var: float = 1.0,
        dim_noise_var: float = 1e-12,
        mbar: int = 10,
        mesh=None,
        axis_name: str = "data",
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        device = resolve_device(x, device)
        dtype = _resolve_dtype(x, dtype)
        x_np, y_np = (t.numpy() for t in check_xy(torch.as_tensor(_numpy(x)), torch.as_tensor(_numpy(y))))
        if grid is None:
            grid = InducingGrid.build(x_np, mbar=mbar)
        self.mesh = mesh if mesh is not None else data_mesh(axis_name=axis_name, device_type=device.type)
        self.axis_name = axis_name
        self.group = self.mesh.get_group(axis_name)
        w = axis_size(self.mesh, axis_name)
        xp, mask = pad_to_multiple(x_np, w)
        yp, _ = pad_to_multiple(y_np, w)
        rows = local_rows(xp.shape[0], self.mesh, axis_name)
        x_loc, y_loc, self.grid, self.xg, self.n_eigs, self.dims, params = init_grief_state(
            xp[rows], yp[rows], kern_list, grid, n_eigs, noise_var, mbar, dtype, device
        )
        self.x, self.y = x_loc, y_loc
        self.mask = _to_tensor(mask[rows], dtype, device)
        self.n_real = int(x_np.shape[0])
        self.kernels = nn.ModuleList(params["kernels"])
        self.log_noise = nn.Parameter(params["log_noise"])
        self.log_w = nn.Parameter(params["log_w"])
        self.dim_noise_var = float(dim_noise_var)
        if device.type == "cuda":
            # Full float32 products, as the single-device model runs them.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _build_and_stats(self):
        basis = build_basis(self.kernels, self.xg, self.n_eigs, dim_noise_var=self.dim_noise_var)
        stats = local_basis_stats(basis, self.kernels, self.xg, self.x, self.y, self.mask, self.group,
                                  n=self.n_real, dims=self.dims, chunk=self.stats_chunk)
        return basis, stats

    def _loss(self) -> torch.Tensor:
        _, stats = self._build_and_stats()
        return basis_nlml(stats, self.log_w, self.log_noise)

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False):
        """Posterior mean (and variance) at ``x_new``, replicated: every rank
        returns the same tensors, on its device."""
        x_new = _to_tensor(x_new, self.x.dtype, self.x.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        with torch.no_grad():
            basis, stats = self._build_and_stats()
            L, theta = basis_posterior(stats, self.log_w, self.log_noise)
            Phis = phi(basis, self.kernels, self.xg, x_new, dims=self.dims)
            mean = Phis @ theta
            if not compute_var:
                return mean
            sigma2 = torch.exp(self.log_noise)
            A = torch.linalg.solve_triangular(L, Phis.T, upper=False)
            var = sigma2 * torch.sum(A**2, dim=0)
            if include_noise:
                var = var + sigma2
        return mean, var
