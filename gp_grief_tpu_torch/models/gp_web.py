"""GPweb: weighted-basis regression over a precomputed feature matrix.

Counterpart of ``gp_grief_tpu.models.gp_web``: given a dense basis ``Φ``
``(n, p)`` from any source, train only the basis weights ``w`` and the noise
``σ²`` (the paper's fast type-II reweighting).  It shares the O(p³)
inversion and determinant-lemma core with ``GPGriefModel``
(``models/base.py``); the O(n·p²) reductions run once, at construction, over
row chunks, so ``n`` never enters the training loop and the model keeps the
statistics, not ``Φ``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gp_grief_tpu_torch.kernels.base import inverse_positive
from gp_grief_tpu_torch.models.base import (
    BaseModel,
    basis_nlml,
    basis_posterior,
    basis_stats_from_phi,
    check_xy,
    resolve_device,
)
from gp_grief_tpu_torch.models.gp_grief import _resolve_dtype, _to_tensor

__all__ = ["GPweb"]


class GPweb(BaseModel):
    """``GPweb(Phi, y, noise_var=1.0, *, stats_chunk=131072, dtype=None, device=None)``.

    ``stats_chunk``: row-block size of the one-time reductions ``ΦᵀΦ``,
    ``Φᵀy``, ``yᵀy``.  ``dtype`` defaults to ``Phi``'s floating type (float32
    stays float32, anything else becomes float64); ``device`` to ``Phi``'s
    device for a tensor ``Phi``, else the card (``device="cpu"`` for the CPU;
    without a CUDA device and without ``device`` the constructor raises).  A
    ``Phi`` already of that dtype on that device is reduced in place: no copy
    is made of it, and the model holds no reference to it.
    """

    def __init__(self, Phi, y, noise_var: float = 1.0, *, stats_chunk: int = 131072,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        dtype = _resolve_dtype(Phi, dtype)
        device = resolve_device(Phi, device)
        if device.type == "cuda":
            # The JAX reference's dots are full float32; TF32 keeps ~3 digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        Phi, y = check_xy(_to_tensor(Phi, dtype, device), _to_tensor(y, dtype, device), what="Phi")
        n, p = Phi.shape
        with torch.no_grad():
            self.stats = basis_stats_from_phi(Phi, y, chunk=int(stats_chunk))
        self.p = int(p)
        self.log_w = nn.Parameter(torch.zeros((p,), dtype=dtype, device=device))
        self.log_noise = nn.Parameter(inverse_positive(noise_var, dtype=dtype, device=device))

    def _loss(self) -> torch.Tensor:
        return basis_nlml(self.stats, self.log_w, self.log_noise)

    def predict(self, Phi_new, compute_var: bool = True, include_noise: bool = False):
        """Posterior mean and, with ``compute_var``, variance at the new
        points from their features ``Φ*`` ``(n*, p)``.  Returns tensors on the
        model's device."""
        Phi_new = _to_tensor(Phi_new, self.log_w.dtype, self.log_w.device)
        with torch.no_grad():
            L, theta = basis_posterior(self.stats, self.log_w, self.log_noise)
            mean = Phi_new @ theta
            if not compute_var:
                return mean
            sigma2 = torch.exp(self.log_noise)
            A = torch.linalg.solve_triangular(L, Phi_new.T, upper=False)
            var = sigma2 * torch.sum(A**2, dim=0)
            if include_noise:
                var = var + sigma2
        return mean, var
