"""Plain reference of the exact GP with an RBF kernel (ARD lengthscales).

``K̃ = v·exp(−½ Σ_d (x_d − x'_d)² / l_d²) + σ²I``, factored by a dense
Cholesky, so every solve is exact.  A training step of the matrix-free model
(BBMM, Gardner et al. 2018) takes the gradient of the surrogate

    −½ αᵀ K̃(θ) α + ½ Σ_r s_rᵀ K̃(θ) z_r / R,    α = K̃⁻¹y, s_r = K̃⁻¹z_r

with ``α`` and ``s`` held fixed, and reports the data fit ``½ yᵀα + (n/2)
log 2π``.  The squared distances take the matrix-product form ``‖a‖² + ‖b‖²
− 2a·b`` of inputs centred on their mean, so the control (TF32 products)
computes them as a float32 user with TF32 on would.  The kernel is built in
row blocks under autograd so that no ``n × n`` graph is kept.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench.reference import Precision

__all__ = ["ExactReference"]


class ExactReference:
    def __init__(self, x, y, *, prec: Precision, device, block: int = 2048):
        self.prec, self.device, self.block = prec, torch.device(device), int(block)
        dt = prec.dtype
        self.x = torch.as_tensor(np.asarray(x), device=self.device).to(dt)
        self.x = self.x - torch.mean(self.x, dim=0, keepdim=True)
        self.y = torch.as_tensor(np.asarray(y), device=self.device).to(dt)
        self.n = int(self.x.shape[0])

    def _block(self, i0: int, i1: int, ls, var):
        a, b = self.x[i0:i1] / ls, self.x / ls
        r2 = torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :] - 2.0 * self.prec.mm(a, b.T)
        return var * torch.exp(-0.5 * torch.clamp_min(r2, 0.0))

    def _gram(self, th) -> torch.Tensor:
        K = torch.empty((self.n, self.n), dtype=self.prec.dtype, device=self.device)
        for i0 in range(0, self.n, self.block):
            i1 = min(self.n, i0 + self.block)
            K[i0:i1] = self._block(i0, i1, th["lengthscale"], th["variance"])
        K.diagonal().add_(th["noise"])
        return K

    def solve(self, th, rhs_bm: torch.Tensor) -> torch.Tensor:
        """``K̃⁻¹`` on the rows of ``rhs_bm (B, n)`` by a dense Cholesky."""
        K = self._gram(th)
        torch.linalg.cholesky(K, out=K)
        sol = torch.cholesky_solve(rhs_bm.T.contiguous(), K, upper=False).T
        del K
        return sol

    def step(self, values_raw: dict, Z: torch.Tensor):
        """One training step at the raw (log) parameters with probes ``Z (R,
        n)``: ``(data fit, {name: surrogate gradient})``."""
        dt = self.prec.dtype
        with torch.no_grad():
            th = {k: torch.exp(v).to(dt) for k, v in values_raw.items()}
            Zd = Z.to(dt)
            sol = self.solve(th, torch.cat([self.y[None, :], Zd], dim=0))
            alpha, S = sol[0], sol[1:]
            fit = 0.5 * float(torch.dot(self.y.double(), alpha.double())) + 0.5 * self.n * math.log(2 * math.pi)
        raw = {k: v.detach().clone().requires_grad_(True) for k, v in values_raw.items()}
        R = Zd.shape[0]
        for i0 in range(0, self.n, self.block):
            i1 = min(self.n, i0 + self.block)
            th = {k: torch.exp(v).to(dt) for k, v in raw.items()}
            Kb = self._block(i0, i1, th["lengthscale"], th["variance"])
            mm = self.prec.mm
            part = (-0.5 * torch.dot(alpha[i0:i1], mm(Kb, alpha[:, None])[:, 0])
                    + 0.5 * torch.sum(S[:, i0:i1] * mm(Zd, Kb.T)) / R)
            part.backward()
        sig = torch.exp(raw["noise"]).to(dt)
        (-0.5 * sig * torch.dot(alpha, alpha) + 0.5 * sig * torch.sum(S * Zd) / R).backward()
        return fit, {k: v.grad.detach().double() for k, v in raw.items()}
