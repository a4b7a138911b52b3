"""Plain reference of GP-GRIEF's iterative NLML (Evans & Nair 2018).

The model: a product RBF kernel on a Cartesian grid ``U`` (one 1-D point set
a dimension), ``K_UU = ⊗_d K_d``, whose top-``p`` eigenpairs ``(λ_j, q_j)``
are products of per-dimension ones, ``λ_j = Π_d λ_{d,i_d}``.  Their Nyström
eigenfunctions at the data are the columns of

    Φ[x, j] = Π_d (K_xU_d Q_d)[x, i_d] · λ_{d,i_d}^{-1/2},

and the kernel is ``ΦWΦᵀ`` with weights ``w``; ``Ã = ΦWΦᵀ + σ²I``.  The top
``r`` eigenpairs ``(s, U)`` of ``ΦWΦᵀ`` come exactly from the ``p × p``
problem ``W^½ΦᵀΦW^½ = V S Vᵀ`` (``U = ΦW^½V S^{-½}``), and ``M = U S Uᵀ +
σ²I`` whitens: with ``M^{-½} = σ⁻¹I + U((s + σ²)^{-½} − σ⁻¹)Uᵀ``,

    yᵀÃ⁻¹y = ỹᵀ B⁻¹ ỹ,  ỹ = M^{-½}y,  B = M^{-½} Ã M^{-½},
    log|Ã| = log|M| + log|B|,  log|M| = Σ log(s + σ²) + (n − r) log σ²,

the quadratic term by plain CG on ``B`` and ``log|B|`` by SLQ on the given
Rademacher probes.

The per-dimension factors and their eigendecomposition run in
``factor_dtype`` (the configuration's float32), with the model's order of
operations: the smallest eigenvalues of a 10-point RBF factor lie far
under float32's resolution of its largest, so the float32 eigenpairs that
enter the top-``p`` products differ from float64's by more than the rest
of the computation, and are what the configuration states.  Everything
after them (the top-``p`` selection, Φ, the factor, the solves) runs in
``prec``'s arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench.reference import Precision
from gpbench.reference.ski import SKIReference

__all__ = ["GriefReference", "top_p"]


def top_p(lams, p: int):
    """Indices ``(p, d)`` of the ``p`` largest products of the per-dimension
    eigenvalues ``lams`` (float64), by a fold over dimensions that keeps the
    ``p`` largest partial log-sums (a product in the top ``p`` has its
    prefixes in the top ``p`` of theirs).  Exact ties (equal factors) are
    kept in the fold's order; a cut through a group of them selects
    whichever members that order puts first."""
    tiny = torch.finfo(torch.float32).tiny
    sums = torch.zeros(1, dtype=torch.float64, device=lams[0].device)
    idx = torch.zeros((1, 0), dtype=torch.int64, device=lams[0].device)
    for lam in lams:
        m = lam.shape[0]
        flat = (sums[:, None] + torch.log(torch.clamp(lam, min=tiny))[None, :]).reshape(-1)
        sums, keep = torch.sort(flat, descending=True, stable=True)
        sums, keep = sums[:p], keep[:p]
        idx = torch.cat([idx[keep // m], (keep % m)[:, None]], dim=1)
    return idx


class GriefReference:
    """GP-GRIEF on ``x (n, d)``, ``y (n,)`` with the grid ``grid`` (one 1-D
    array a dimension), ``n_eigs`` eigenfunctions and a rank-``precond_rank``
    whitening, in ``prec``'s arithmetic on ``device``.  Parameters are
    passed as positive values: ``{"lengthscale": (d,), "variance": (d,),
    "noise": (), "w": (p,)}``, and taken as a model of ``factor_dtype``
    holds them (:meth:`held`)."""

    # Plain CG to ``prec.cg_tol`` and the Lanczos quadrature: the SKI
    # reference's own.
    cg = SKIReference.cg
    slq = SKIReference.slq

    def __init__(self, x, y, grid, *, n_eigs: int, precond_rank: int, dim_noise_var: float, prec: Precision,
                 device, factor_dtype=torch.float32, row_block: int = 131072):
        self.prec, self.device = prec, torch.device(device)
        self.x = torch.as_tensor(np.asarray(x), device=self.device).to(torch.float64)
        self.y = torch.as_tensor(np.asarray(y), device=self.device).to(prec.dtype)
        self.fdt = factor_dtype
        self.grid = [torch.as_tensor(np.asarray(g).reshape(-1), device=self.device).to(factor_dtype) for g in grid]
        self.n, self.d = int(self.x.shape[0]), int(self.x.shape[1])
        self.p, self.r = int(n_eigs), int(precond_rank)
        self.jitter, self.row_block = float(dim_noise_var), int(row_block)

    # -- pieces ------------------------------------------------------------------

    def held(self, values, key: str) -> torch.Tensor:
        """Parameter ``key`` as the model holds it: its log rounded to
        ``factor_dtype`` (the configuration's), exponentiated there."""
        raw = torch.log(torch.as_tensor(np.asarray(values[key], np.float64), device=self.device))
        return torch.exp(raw.to(self.fdt))

    def basis(self, values):
        """``(Q, λ, idx)``: the per-dimension eigenpairs (``factor_dtype``,
        one batched ``eigh``) and the ``(p, d)`` selection of the top ``p``
        products."""
        ls, var = self.held(values, "lengthscale"), self.held(values, "variance")
        Ks = []
        for d, g in enumerate(self.grid):
            xs = g[:, None] / ls[d]
            dd = xs[:, None, :] - xs[None, :, :]
            K = var[d] * torch.exp(-0.5 * torch.sum(dd * dd, dim=-1))
            Ks.append(K + self.jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device))
        lam, Q = torch.linalg.eigh(torch.stack(Ks))
        p = min(self.p, math.prod(int(g.shape[0]) for g in self.grid))
        return Q, lam, top_p([lm.to(torch.float64) for lm in lam], p)

    def phi(self, values, Q, lam, idx, rows=slice(None)):
        """Φ at the data rows ``rows``, ``(rows, p)`` in ``prec``'s dtype."""
        ls, var = self.held(values, "lengthscale"), self.held(values, "variance")
        dt, tiny = self.prec.dtype, torch.finfo(torch.float32).tiny
        x = self.x[rows]
        out = None
        for d in range(self.d):
            g = self.grid[d].to(torch.float64)
            ld = ls[d].to(torch.float64)
            Kx = var[d].to(torch.float64) * torch.exp(-0.5 * ((x[:, d, None] - g[None, :]) / ld) ** 2)
            sel = idx[:, d]
            S = Q[d].to(torch.float64)[:, sel] * torch.clamp(lam[d].to(torch.float64), min=tiny)[sel] ** -0.5
            G = self.prec.mm(Kx.to(dt), S.to(dt))
            out = G if out is None else out * G
        return out

    def phi_all(self, values, Q, lam, idx):
        return torch.cat([self.phi(values, Q, lam, idx, slice(s, s + self.row_block))
                          for s in range(0, self.n, self.row_block)])

    def factor(self, Phi, w):
        """``(U, s)``: the top ``r`` eigenpairs of ``ΦWΦᵀ`` from the ``p × p``
        problem, ``s`` ascending."""
        sw = torch.sqrt(w)
        H = sw[:, None] * self.prec.mm(Phi.T, Phi) * sw[None, :]
        s, V = torch.linalg.eigh(H)
        s, V = s[-self.r :], V[:, -self.r :]
        return self.prec.mm(Phi, sw[:, None] * V / torch.sqrt(s)[None, :]), s

    # -- the model's quantities ------------------------------------------------

    def nlml(self, values: dict, Z: torch.Tensor, lanczos_iters: int) -> float:
        """The NLML at ``values`` with SLQ probes ``Z (R, n)``."""
        dt, mm = self.prec.dtype, self.prec.mm
        with torch.no_grad():
            Phi = self.phi_all(values, *self.basis(values))
            w = self.held(values, "w").to(dt)
            sigma2 = float(self.held(values, "noise"))
            U, s = self.factor(Phi, w)
            b = sigma2**-0.5
            delta = 1.0 / torch.sqrt(s + sigma2) - b

            def m_isqrt(v):
                return b * v + mm(mm(v, U) * delta[None, :], U.T)

            def white(v):
                u = m_isqrt(v)
                return m_isqrt(mm(mm(u, Phi) * w[None, :], Phi.T) + sigma2 * u)

            rhs = m_isqrt(self.y[None, :])
            quad = float(torch.dot(rhs[0].double(), self.cg(white, rhs)[0].double()))
            ld_M = float(torch.sum(torch.log(s.double() + sigma2))) + (self.n - self.r) * math.log(sigma2)
            ld_B = self.slq(white, Z.to(dt), lanczos_iters)
            return 0.5 * (quad + ld_M + ld_B + self.n * math.log(2 * math.pi))
