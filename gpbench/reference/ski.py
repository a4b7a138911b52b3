"""Plain reference of KISS-GP (SKI) through the whitened lattice dual.

The model (Wilson & Nickisch 2015): ``k̂(x, z) = w(x)ᵀ K w(z)`` with ``K =
⊗_d K_d`` the kernel on a Cartesian lattice of ``M`` points and ``w`` the
multilinear interpolation weights (``2^d`` corners a point, clamped to the
boundary cell).  With ``Â = W K Wᵀ + σ²I`` the dual ``B = σ²K⁻¹ + WᵀW`` is
whitened in the Kronecker eigenbasis ``K = Q Λ Qᵀ`` by ``D = diag(√(λ /
(σ² + c̄λ)))``, ``c̄ = tr(WᵀW)/M``:

    W̃ = I + D Qᵀ (WᵀW − c̄I) Q D,      ṽ = D Qᵀ Wᵀ y,
    yᵀÂ⁻¹y = (yᵀy − ṽᵀ W̃⁻¹ ṽ) / σ²,
    log|Â| = (n − M) log σ² + Σ log(σ² + c̄λ) + log|W̃|.

``log|W̃|`` is the SLQ estimate on Rademacher probes ``z`` in that basis,
and a training step's surrogate is the NLML with the solves ``γ = W̃⁻¹ṽ``,
``S = W̃⁻¹z`` held fixed and ``log|W̃|`` replaced by ``Σ S ⊙ W̃z / R``, whose
gradient is the Hutchinson estimate of ``∂ log|W̃|``.

The probes are coordinates in the eigenbasis, so the basis must be the
model's: each eigenvector is signed so that its first entry of at least a
tenth of its largest magnitude is positive, the per-dimension eigenvalues
are clamped at ``10·ε·λmax``, and the factors and their eigendecomposition
are computed in float32, the configuration's dtype, with the model's order
of operations.  At ski1m_lattice 23 of each factor's 32 eigenvalues sit
under the clamp, and the basis of that block is whatever float32 rounding
makes it; everything after the eigendecomposition runs in ``prec``'s dtype.

``WᵀW`` is applied as ``Wᵀ(W v)`` with ``W`` a sparse CSR matrix.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from gpbench.reference import Precision

__all__ = ["SKIReference"]

F32_EPS = float(np.finfo(np.float32).eps)


class _SymOp(torch.autograd.Function):
    """``G v`` for a constant symmetric sparse ``G = WᵀW`` given as its two
    CSR halves; the backward is ``G`` again."""

    @staticmethod
    def forward(ctx, v, W, Wt):
        ctx.W, ctx.Wt = W, Wt
        return _wtw(W, Wt, v)

    @staticmethod
    def backward(ctx, g):
        return _wtw(ctx.W, ctx.Wt, g), None, None


def _wtw(W, Wt, v_bm):
    return (Wt @ (W @ v_bm.T)).T


def _canonical(Q: torch.Tensor) -> torch.Tensor:
    a = Q.abs()
    first = torch.argmax((a >= 0.1 * a.amax(dim=0, keepdim=True)).to(torch.int32), dim=0)
    s = torch.sign(Q[first, torch.arange(Q.shape[1], device=Q.device)])
    return Q * torch.where(s == 0, torch.ones_like(s), s)[None, :]


def _kron_apply(mats, V: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """``(I_B ⊗ A_1 ⊗ … ⊗ A_d)`` on batch-major ``V (B, M)``, one axis at a time."""
    B = V.shape[0]
    shape = [B] + [int(A.shape[1]) for A in mats]
    X = V.reshape(shape)
    for d, A in enumerate(mats):
        X = torch.movedim(mm(A, torch.movedim(X, d + 1, -2)), -2, d + 1)
    return X.reshape(B, -1)


class SKIReference:
    """The SKI model of ``x (n, d)``, ``y (n,)`` on the lattice ``grid`` (one
    1-D array a dimension) with product RBF kernels, in ``prec``'s
    arithmetic on ``device``.  Parameters are passed as positive values:
    ``{"lengthscale": (d,), "variance": (d,), "noise": ()}``."""

    def __init__(self, x, y, grid, *, prec: Precision, device):
        self.prec, self.device = prec, torch.device(device)
        dt = prec.dtype
        x = torch.as_tensor(np.asarray(x), device=self.device).to(torch.float64)
        self.y = torch.as_tensor(np.asarray(y), device=self.device).to(dt)
        self.grid32 = [torch.as_tensor(np.asarray(g, np.float32).reshape(-1), device=self.device) for g in grid]
        self.grid = [g.to(torch.float64) for g in self.grid32]
        self.n, self.d = int(x.shape[0]), int(x.shape[1])
        self.shape = tuple(int(g.shape[0]) for g in self.grid)
        self.M = math.prod(self.shape)
        cols, vals = self._corners(x)
        self.cbar = float(torch.sum(vals * vals)) / self.M
        rows = torch.arange(self.n, device=self.device).repeat_interleave(cols.shape[1])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # PyTorch calls its sparse tensors "beta"
            coo = torch.sparse_coo_tensor(torch.stack([rows, cols.reshape(-1)]), vals.reshape(-1).to(dt),
                                          (self.n, self.M)).coalesce()
            self.W = coo.to_sparse_csr()
            self.Wt = coo.t().coalesce().to_sparse_csr()
        self.yty = float(torch.dot(self.y.double(), self.y.double()))

    # -- pieces ------------------------------------------------------------------

    def w_t(self, u_bm):
        """``Wᵀu`` for ``(B, n)`` rows."""
        return (self.Wt @ u_bm.T).T

    def wtw(self, v_bm):
        return _SymOp.apply(v_bm, self.W, self.Wt)

    def factors(self, raw):
        """``K_d = v_d·exp(−½ (g_i/l_d − g_j/l_d)²)`` from the raw (log)
        parameters, in float32 with the model's order of operations: the
        configuration states float32, and the eigenbasis of the clamped block
        below is set by float32 rounding."""
        out = []
        for d, g in enumerate(self.grid32):
            ls = torch.exp(raw["lengthscale"][d].to(torch.float32)).reshape(1)
            var = torch.exp(raw["variance"][d].to(torch.float32))
            xs = g[:, None] / ls
            dd = xs[:, None, :] - xs[None, :, :]
            out.append(var * torch.exp(-0.5 * torch.sum(dd * dd, dim=-1)))
        return out

    def spectra(self, raw):
        """``(Q_d, D (M,), Σ log(σ² + c̄λ))`` at the raw parameters: the
        per-dimension eigendecomposition in float32 (one batched ``eigh``,
        signed, clamped at ``10·ε₃₂·λmax``), the rest in ``prec``'s dtype."""
        dt = self.prec.dtype
        lam32, Q32 = torch.linalg.eigh(torch.stack(self.factors(raw), dim=0))
        Qs, lam = [], None
        for ev, Q in zip(lam32.unbind(0), Q32.unbind(0)):
            ev = torch.maximum(ev, 10.0 * F32_EPS * torch.max(ev)).to(dt)
            Qs.append(_canonical(Q).to(dt))
            lam = ev if lam is None else (lam[:, None] * ev[None, :]).reshape(-1)
        sigma2 = torch.exp(raw["noise"]).to(dt)
        wjs = torch.sqrt(lam / (sigma2 + self.cbar * lam))
        return Qs, wjs, torch.sum(torch.log(sigma2 + self.cbar * lam))

    def ops(self, Qs, wjs):
        QsT = [Q.T for Q in Qs]

        def to_dual(v):
            return _kron_apply(QsT, v, self.prec.mm) * wjs[None, :]

        def from_dual(v):
            return _kron_apply(Qs, v * wjs[None, :], self.prec.mm)

        def white(v):
            u = from_dual(v)
            return v + to_dual(self.wtw(u) - self.cbar * u)

        return to_dual, from_dual, white

    def cg(self, op, rhs, max_iters: int = 2000):
        """Plain CG on each row of ``rhs`` to ``prec.cg_tol`` relative."""
        x = torch.zeros_like(rhs)
        r = rhs.clone()
        p = r.clone()
        rr = torch.sum(r * r, dim=1)
        stop = (self.prec.cg_tol**2) * rr
        for _ in range(max_iters):
            if bool(torch.all(rr <= stop)):
                break
            Ap = op(p)
            a = rr / torch.sum(p * Ap, dim=1)
            x = x + a[:, None] * p
            r = r - a[:, None] * Ap
            rr_new = torch.sum(r * r, dim=1)
            p = r + (rr_new / rr)[:, None] * p
            rr = rr_new
        return x

    def slq(self, op, Z, k: int) -> float:
        """``mean_r ‖z_r‖² Σ_j τ_j² log θ_j`` from ``k`` Lanczos steps per probe
        (the Gauss quadrature of ``zᵀ log(A) z``)."""
        R = Z.shape[0]
        q = Z / torch.sqrt(torch.sum(Z * Z, dim=1))[:, None]
        q_prev = torch.zeros_like(q)
        beta = torch.zeros(R, dtype=Z.dtype, device=Z.device)
        alphas, betas = [], []
        for j in range(k):
            w = op(q) - beta[:, None] * q_prev
            a = torch.sum(w * q, dim=1)
            w = w - a[:, None] * q
            alphas.append(a)
            beta = torch.sqrt(torch.sum(w * w, dim=1))
            betas.append(beta)
            q_prev, q = q, w / beta[:, None]
        A = torch.stack(alphas, 1).double().cpu().numpy()
        Bt = torch.stack(betas, 1).double().cpu().numpy()
        zn2 = torch.sum(Z.double() * Z.double(), dim=1).cpu().numpy()
        total = 0.0
        for i in range(R):
            T = np.diag(A[i]) + np.diag(Bt[i, :-1], 1) + np.diag(Bt[i, :-1], -1)
            ev, V = np.linalg.eigh(T)
            total += zn2[i] * float(np.sum(V[0] ** 2 * np.log(ev)))
        return total / R

    # -- the model's quantities ------------------------------------------------

    def _raw(self, values: dict) -> dict:
        """Positive values → raw (log) float64 parameters."""
        return {k: torch.log(torch.as_tensor(np.asarray(v, dtype=np.float64), device=self.device))
                for k, v in values.items()}

    def nlml(self, values: dict, Z: torch.Tensor, lanczos_iters: int) -> float:
        """The NLML at ``values`` with SLQ probes ``Z (R, M)``."""
        with torch.no_grad():
            raw = self._raw(values)
            sigma2 = torch.exp(raw["noise"])
            Qs, wjs, ld_mk = self.spectra(raw)
            to_dual, _, white = self.ops(Qs, wjs)
            vt = to_dual(self.w_t(self.y[None, :]))
            gam = self.cg(white, vt)
            quad = (self.yty - float(torch.dot(vt[0].double(), gam[0].double()))) / float(sigma2)
            ld_white = self.slq(white, Z.to(self.prec.dtype), lanczos_iters)
            ld = (self.n - self.M) * math.log(float(sigma2)) + float(ld_mk) + ld_white
            return 0.5 * (quad + ld + self.n * math.log(2 * math.pi))

    def step(self, values_raw: dict, Z: torch.Tensor):
        """One training step's surrogate and its gradient at the raw (log)
        parameters ``values_raw`` with probes ``Z (R, M)``: ``(value, {name:
        gradient})``."""
        with torch.no_grad():
            Qs, wjs, _ = self.spectra(values_raw)
            to_dual, _, white = self.ops(Qs, wjs)
            Zd = Z.to(self.prec.dtype)
            sol = self.cg(white, torch.cat([to_dual(self.w_t(self.y[None, :])), Zd], dim=0))
        raw = {k: v.detach().clone().requires_grad_(True) for k, v in values_raw.items()}
        sigma2 = torch.exp(raw["noise"]).to(self.prec.dtype)
        Qs, wjs, ld_mk = self.spectra(raw)
        to_dual, _, white = self.ops(Qs, wjs)
        vt = to_dual(self.w_t(self.y[None, :]))[0]
        gam = sol[0]
        quad = (self.yty - 2.0 * torch.dot(vt.double(), gam.double())
                + torch.dot(gam.double(), white(gam[None, :])[0].double())) / sigma2.double()
        hutch = torch.sum(sol[1:] * white(Zd)) / Zd.shape[0]
        ld = (self.n - self.M) * torch.log(sigma2.double()) + ld_mk.double() + hutch.double()
        val = 0.5 * (quad + ld + self.n * math.log(2 * math.pi))
        val.backward()
        return float(val.detach()), {k: v.grad.detach().double() for k, v in raw.items()}

    def predict(self, values: dict, xs) -> tuple:
        """Predictive mean and latent variance at ``xs (c, d)``."""
        with torch.no_grad():
            raw = self._raw(values)
            Qs, wjs, _ = self.spectra(raw)
            to_dual, from_dual, white = self.ops(Qs, wjs)
            Ws = self._interp_rows(xs)  # (c, M) dense test interpolation rows
            vt = to_dual(self.w_t(self.y[None, :]))
            kw_alpha = from_dual(self.cg(white, vt))[0]  # K Wᵀ Â⁻¹ y = B⁻¹ Wᵀy
            mean = Ws @ kw_alpha
            facs = [K.to(self.prec.dtype) for K in self.factors(raw)]
            KWs = _kron_apply(facs, Ws, self.prec.mm)
            prior = torch.sum(Ws * KWs, dim=1)
            G = self.wtw(from_dual(self.cg(white, to_dual(Ws))))  # WᵀW B⁻¹ w*
            var = prior - torch.sum(Ws * _kron_apply(facs, G, self.prec.mm), dim=1)
            return mean, torch.clamp_min(var, 0.0)

    def _corners(self, x: torch.Tensor) -> tuple:
        """Each point's ``2^d`` lattice corners (flat indices) and their
        multilinear weights, ``(n, 2^d)`` each, in float64."""
        cols = torch.zeros((x.shape[0], 1), dtype=torch.int64, device=self.device)
        vals = torch.ones((x.shape[0], 1), dtype=torch.float64, device=self.device)
        stride = self.M
        for d, g in enumerate(self.grid):
            m = g.shape[0]
            stride //= m
            left = torch.clamp(torch.searchsorted(g, x[:, d].contiguous(), right=True) - 1, 0, m - 2)
            t = torch.clamp((x[:, d] - g[left]) / (g[left + 1] - g[left]), 0.0, 1.0)
            cols = torch.cat([cols + left[:, None] * stride, cols + (left[:, None] + 1) * stride], dim=1)
            vals = torch.cat([vals * (1.0 - t)[:, None], vals * t[:, None]], dim=1)
        return cols, vals

    def _interp_rows(self, xs) -> torch.Tensor:
        """Dense ``(c, M)`` interpolation rows of the test points ``xs``."""
        cols, vals = self._corners(torch.as_tensor(np.asarray(xs), device=self.device).to(torch.float64))
        out = torch.zeros((cols.shape[0], self.M), dtype=self.prec.dtype, device=self.device)
        out.scatter_add_(1, cols, vals.to(self.prec.dtype))
        return out
