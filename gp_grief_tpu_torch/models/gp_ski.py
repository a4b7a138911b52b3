"""SKI / KISS-GP regression: scattered data tied to a grid by interpolation.

Counterpart of ``gp_grief_tpu.models.gp_ski.GPSKIRegression``: the log
marginal likelihood, its training and ``predict``, for both solvers.  The
kernel is approximated as ``k̂(x, z) = W_x (⊗_d K_d) W_zᵀ`` with sparse linear
interpolation weights ``W`` (``ops/interp.py``), so every apply of
``K̂ + σ²I`` is gather → Kronecker matvec → ``Wᵀ``.  The NLML takes CG for
the quadratic term and SLQ for the log-determinant; training differentiates
the BBMM stop-gradient surrogates (the solves and the SLQ value carry no
gradient, and ``log|Â|``'s gradient is a Hutchinson estimate on the CG probe
solves).

On the card ``Wᵀ`` is kernel K4 in every regime, the lattice dual's ``WᵀW``
is kernel K5, and the Kronecker matvecs go through ``kron_matvec_fast``
(kernels K2/K3 where its gates send them).  ``W``'s gradient is ``Wᵀ`` (K4,
``ops.cuda.interp.interp_w``), never a scatter, so training is deterministic
on one card.  The JAX package's segmented programs become one host driver
each (``optimize_segmented``, ``log_likelihood_segmented``); its
``safe_batch_op`` wrappers exist for a TPU runtime and are not ported.

Two choices keep the stochastic estimates independent of the eigensolver, so
that the card and the JAX package agree on the same probes: the per-dimension
eigenvectors are sign-canonicalized (the lattice dual draws its probes in the
Kronecker eigenbasis), and the rank-r deflation orders tied eigenvalue
products by index (``top_p_kron_eigs(tie_quantum=...)``).
"""

from __future__ import annotations

import copy
import functools
import math
import time
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from gp_grief_tpu_torch.grid import InducingGrid
from gp_grief_tpu_torch.kernels.base import inverse_positive
from gp_grief_tpu_torch.kernels.grid import cov_grid
from gp_grief_tpu_torch.kernels.stationary import Stationary
from gp_grief_tpu_torch.models.base import BaseModel, check_xy, resolve_device
from gp_grief_tpu_torch.optimize import FitResult
from gp_grief_tpu_torch.models.gp_kron import _clamp_psd
from gp_grief_tpu_torch.ops import lanczos as _lz
from gp_grief_tpu_torch.ops.cg import CGInfo, cg_segments, cg_solve, cg_solve_refined
from gp_grief_tpu_torch.ops.cuda.interp import interp_w, interp_wt
from gp_grief_tpu_torch.ops.fused import fused_cg_slq
from gp_grief_tpu_torch.ops.interp import (
    build_corner_stream,
    build_interp_plan,
    interp_matvec,
    interp_matvec_bm,
    interp_matvec_bm_fast,
    interp_rmatvec_bm,
    interp_weights,
    iw_to_torch,
)
from gp_grief_tpu_torch.ops.interp_stencil import build_wtw_stencil, make_wtw_stencil_op
from gp_grief_tpu_torch.ops.kron import kron_eigh, lam_kron
from gp_grief_tpu_torch.ops.kron_fast import X3, batch_identity, kron_matvec_fast
from gp_grief_tpu_torch.ops.precond import lowrank_spectral_factor, lowrank_sqrt_ops
from gp_grief_tpu_torch.ops.solve import cholesky
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["GPSKIRegression", "lattice_cbar", "warn_lattice_small_n"]

_nlml_span = _prof.site("gp_grief.model.nlml", entry=True)
_step_span = _prof.site("gp_grief.model.step", "step", entry=True)
_step_solve_span = _prof.site("gp_grief.model.step.solve")
_step_grad_span = _prof.site("gp_grief.model.step.grad")

# Log-eigenvalue sums closer than this are ties, broken by index (see the
# module docstring); far above each precision's eigensolver noise at the
# products the deflation keeps.
TIE_QUANTUM = {torch.float64: 1e-7, torch.float32: 1e-4}


def warn_lattice_small_n(n: int, xg) -> None:
    """Warn when ``solver='lattice'`` is requested at n << m: the dual's
    log-det assembles O(M·log σ²)-scale terms whose SLQ quadrature bias can
    dominate the NLML there (the JAX package's measurement); the data solver
    is the right one for n < m/4."""
    m_total = int(np.prod([int(g.shape[0]) for g in xg]))
    if n < m_total // 4:
        warnings.warn(
            "solver='lattice' at n << m: the dual log-det assembles "
            "O(M·log σ²)-scale terms whose SLQ quadrature bias can "
            "dominate the NLML (measured: 100k points on a 1M lattice "
            "was off by ~1e5 at lanczos_iters=30 while solver='data' "
            "converges fine there).  Prefer solver='data' when "
            "n < m/4; the dual is for n ≳ m where the data-space "
            "operator exceeds f32 CG conditioning.",
            stacklevel=3,
        )


def lattice_cbar(iw, stream=None) -> float:
    """Mean of ``diag(WᵀW)`` for a NumPy :class:`InterpWeights`:
    ``Σ w² / M`` over the corner-update stream (host, θ-independent)."""
    M = math.prod(iw.shape)
    st = stream if stream is not None else build_corner_stream(iw)
    return float(np.sum(st.w_u.astype(np.float64) ** 2) / M)


def _canonical_signs(Q: torch.Tensor) -> torch.Tensor:
    """Flip each eigenvector so its first entry with |q| ≥ 0.1·max|q| is positive."""
    a = Q.abs()
    first = torch.argmax((a >= 0.1 * a.amax(dim=0, keepdim=True)).to(torch.int32), dim=0)
    s = torch.sign(Q[first, torch.arange(Q.shape[1], device=Q.device)])
    return Q * torch.where(s == 0, torch.ones_like(s), s)[None, :]


def _kron_eigh_canonical(factors):
    Qs, lams = kron_eigh(factors)
    return tuple(_canonical_signs(Q) for Q in Qs), lams


def _timed_plan(fn):
    """A lazily built plan: computed at first access, cached on the model,
    its own host build time (the shared stream built and timed first) kept in
    ``model.plan_seconds``."""

    @functools.wraps(fn)
    def build(self):
        if fn.__name__ != "_cstream":
            self._cstream
        t0 = time.perf_counter()
        out = fn(self)
        self.plan_seconds[fn.__name__.lstrip("_")] = time.perf_counter() - t0
        return out

    return functools.cached_property(build)


def _dual_quad(yty64: torch.Tensor, vt: torch.Tensor, gam: torch.Tensor, white, sigma2) -> torch.Tensor:
    """The lattice dual's data term ``quad = (yᵀy − 2ṽᵀγ + γᵀW̃γ)/σ²`` in
    ``gam``'s dtype, from ``yᵀy`` summed in float64.  The three sums cancel
    to about 1/127 of themselves before σ² (0.05 at ski1m_lattice) scales
    them up, so each is accumulated in float64: in float32 one rounding of a
    10⁶-term dot moves the NLML by 0.3 (5e-7 of it), more than a sharded
    run's true gap to one card (``tools/ski_shard_terms.py``)."""
    f64 = torch.float64
    quad = yty64 - 2.0 * torch.dot(vt.to(f64), gam.to(f64)) + torch.dot(gam.to(f64), white(gam[None, :])[0].to(f64))
    return (quad / sigma2).to(gam.dtype)


class GPSKIRegression(BaseModel):
    """``GPSKIRegression(x, y, kern_list, grid, noise_var=..., ...)``.

    ``grid`` may be an :class:`InducingGrid` or per-dimension point arrays
    (``(m_d,)`` or ``(m_d, 1)``); ``None`` builds one from ``x`` with
    ``mbar``.  ``solver="data"`` runs CG on the ``n × n`` operator
    ``K̂ + σ²I`` with a rank-``precond_rank`` deflation preconditioner (also
    whitening SLQ); ``solver="lattice"`` the Woodbury dual on the ``M × M``
    lattice operator ``σ²K⁻¹ + WᵀW``, whitened in closed form (for n ≳ m).

    ``dtype`` defaults to ``x``'s floating type (float32 stays float32,
    anything else becomes float64); ``device`` to ``x``'s device for a tensor
    ``x``, else the card (``device="cpu"`` for the CPU).  ``seed`` seeds the
    ``torch.Generator`` of the NLML's Rademacher probes (fresh per
    evaluation, so repeated evaluations agree, as with the JAX package's
    fixed key).  ``lattice_x3`` sends the lattice dual's Q/Qᵀ applies to the
    X3 preset on the card (``kron_matvec_fast``).  ``train_mixed16`` runs
    :meth:`optimize_segmented`'s lattice-dual solves with bf16 state and bf16
    Kronecker inputs (the data solver ignores it); the reported NLML and
    predictions always solve in the working dtype.

    ``optimize`` trains through :func:`~gp_grief_tpu_torch.optimize.fit` on
    the surrogate gradient of :meth:`_loss`; :meth:`optimize_segmented` is
    the per-step host driver for large ``n``.
    """

    def __init__(
        self,
        x,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        grid=None,
        *,
        noise_var: float = 1.0,
        dim_noise_var: float = 0.0,
        mbar: int = 30,
        num_probes: int = 16,
        lanczos_iters: int = 40,
        cg_tol: float = 1e-8,
        cg_iters: int = 500,
        cg_precision: str = "exact",
        precond_rank: int = 256,
        solver: str = "data",
        wtw_stencil: bool = True,
        lattice_x3: bool = True,
        train_mixed16: bool = False,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if dtype is None:
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                dtype = x.dtype
            else:
                dtype = torch.float32 if np.asarray(x).dtype == np.float32 else torch.float64
        device = resolve_device(x, device)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64

        def _np(a):
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            return a.astype(np_dtype)

        x_t, y_t = check_xy(torch.as_tensor(_np(x)), torch.as_tensor(_np(y)))
        if grid is None:
            grid = InducingGrid.build(x_t.numpy(), mbar=mbar)
        xg = grid.xg if isinstance(grid, InducingGrid) else grid
        xg_np = [_np(g) for g in xg]
        if any(g.ndim == 2 and g.shape[1] > 1 for g in xg_np):
            raise NotImplementedError(
                "multi-column (sub_dim > 1) grid dimensions are not supported by "
                "linear grid interpolation — use GPGriefModel with grouped dims"
            )
        xg_np = [g.reshape(-1) for g in xg_np]
        self.dtype, self.device = dtype, device
        self.xg = tuple(torch.as_tensor(g[:, None], device=device) for g in xg_np)
        self.x = x_t.to(device)
        self.y = y_t.to(device)
        self.n, self.M = int(x_t.shape[0]), math.prod(g.shape[0] for g in xg_np)
        # The host weights feed the plans (built on the host); their device
        # copy the deflation basis.
        self._iw_np = interp_weights(x_t.numpy(), xg_np)
        self.iw = iw_to_torch(self._iw_np, dtype=dtype, device=device)
        self.plan_seconds = {}
        self.dim_noise_var = float(dim_noise_var)
        if cg_precision not in ("exact", "mixed"):
            raise ValueError("cg_precision must be 'exact' or 'mixed'")
        if solver not in ("data", "lattice"):
            raise ValueError("solver must be 'data' or 'lattice'")
        self.solver = solver
        self._use_wtw_stencil = bool(wtw_stencil)
        self._lattice_x3 = bool(lattice_x3)
        self._train_mixed16 = bool(train_mixed16)
        if solver == "lattice":
            warn_lattice_small_n(self.n, xg_np)
        self._opts = dict(
            num_probes=int(num_probes), lanczos_iters=int(lanczos_iters), cg_tol=float(cg_tol),
            cg_iters=int(cg_iters), cg_precision=cg_precision, precond_rank=int(precond_rank),
        )
        self.seed = int(seed)
        # CGInfo of the last NLML's solve (None before one).
        self.cg_info: Optional[CGInfo] = None
        # CG iterations of the last host driver's solve (optimize_segmented's
        # step, log_likelihood_segmented), as dispatched (None before one).
        self.cg_iterations: Optional[int] = None
        kerns = list(kern_list) if isinstance(kern_list, (list, tuple)) else [kern_list] * len(xg_np)
        self.kernels = nn.ModuleList([copy.deepcopy(k).to(dtype=dtype, device=device) for k in kerns])
        self.log_noise = nn.Parameter(inverse_positive(noise_var, dtype=dtype, device=device))
        if device.type == "cuda":
            # The JAX reference's dots are full float32; TF32 keeps ~3 digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    # -- lazily built plans (host NumPy, once per model) -------------------------

    @_timed_plan
    def _cstream(self):
        """The shared corner-update stream every plan starts from."""
        return build_corner_stream(self._iw_np)

    @_timed_plan
    def _plan(self):
        """The interpolation plan: K4's cell-sorted stream, the forward
        gather tables and the ELL slots of K4's plain version."""
        return build_interp_plan(self._iw_np, stream=self._cstream, dtype=self.dtype, device=self.device)

    @_timed_plan
    def _wtw_stencil(self):
        """``WᵀW`` as ≤3^d offset tables (None when disabled or over the
        memory gate)."""
        if not self._use_wtw_stencil:
            return None
        return build_wtw_stencil(self._iw_np, stream=self._cstream, dtype=self.dtype, device=self.device)

    @functools.cached_property
    def _wtw_op(self):
        return make_wtw_stencil_op(self._wtw_stencil) if self._wtw_stencil is not None else None

    # -- structured operator ---------------------------------------------------

    def _factors(self):
        return tuple(K.contiguous() for K in cov_grid(self.kernels, self.xg, dim_noise_var=self.dim_noise_var))

    def _generator(self, step: Optional[int] = None) -> torch.Generator:
        """The probes' generator: seeded from ``seed`` for an NLML, and from
        ``(seed, 1000 + step)`` for a training step of
        :meth:`optimize_segmented` (JAX: ``fold_in(key, 1000 + it)``)."""
        seed = self.seed
        if step is not None:
            seed = int(np.random.SeedSequence([self.seed, 1000 + int(step)]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _needs_grad(self) -> bool:
        return torch.is_grad_enabled() and any(p.requires_grad for _, p in self.named_parameters())

    def _rmatvec_bm(self, u_bm):
        """Batch-major ``Wᵀ u`` ``(B, n) → (B, M)``: kernel K4 on the card in
        every regime (the JAX package's one-hot/windowed choice is a TPU
        layout decision), K4's plain version (the exact ELL form) on the CPU.
        The JAX package's running-sum form (``fast=True``, ~5e-5 relative in
        float32) is never dispatched; ``ops.interp.interp_rmatvec_bm_fast``
        keeps it."""
        return interp_wt(self._plan, u_bm)

    def _w_bm(self, v_lat_bm):
        """Batch-major forward ``W v`` ``(B, M) → (B, n)``: one fused gather,
        differentiated by ``Wᵀ`` (K4 on the card)."""
        return interp_w(self._plan, v_lat_bm)

    def _matvec_bm(self, factors, sigma2, precision=None):
        """Batch-major ``(K̂ + σ²I)``: ``v (B, n) → (B, n)``, the batch folded
        into the Kronecker structure as a leading identity factor
        (``I_B ⊗ (⊗K_d)`` on the ``(B·M,)`` flat vector), the JAX package's
        call form; a ``batch_identity``, so K2/K3 fold it into their rows."""
        precision = "highest" if precision is None else precision

        def mv(v):
            B = int(v.shape[0])
            u = self._rmatvec_bm(v)
            eyeB = batch_identity(B, dtype=v.dtype, device=v.device)
            u = kron_matvec_fast((eyeB, *factors), u.reshape(-1), precision=precision).reshape(B, -1)
            return self._w_bm(u) + sigma2 * v

        return mv

    def _matvec(self, factors, sigma2, precision=None):
        """Column-layout form (``(n,)`` / ``(n, B)``) of :meth:`_matvec_bm`."""
        mv_bm = self._matvec_bm(factors, sigma2, precision)

        def mv(v):
            if v.ndim == 1:
                return mv_bm(v[None, :])[0]
            return mv_bm(v.T.contiguous()).T

        return mv

    def _build_precond(self, factors, sigma2):
        """Rank-r deflation of ``A = W K Wᵀ + σ²I`` from the top-r Kronecker
        eigenpairs of the lattice Gram projected to the data points
        (``B₀ = W Q_r Λ_r^{1/2}``, a Khatri-Rao column gather), orthonormalized
        by :func:`lowrank_spectral_factor`.  Returns ``(M_inv, M_inv_sqrt,
        logdet_M)`` or ``None`` (rank 0)."""
        r = self._precond_rank()
        if r <= 0:
            return None
        U, lam = self._precond_spectral(factors, r)
        return lowrank_sqrt_ops(U, lam, sigma2, layout="bm")

    def _precond_rank(self) -> int:
        """``precond_rank`` capped at the lattice and data sizes."""
        r = self._opts["precond_rank"]
        if r <= 0:
            return 0
        return min(r, self.M, self.n)

    def _precond_spectral(self, factors, r):
        """``(U (n, r) orthonormal, lam (r,))`` of the deflation basis."""
        Qs, lams = _kron_eigh_canonical(factors)
        log_lam, idx = top_p_kron_eigs(lams, r, tie_quantum=TIE_QUANTUM.get(lams[0].dtype))
        lam_r = torch.exp(log_lam)
        U0 = None
        for d_, Qd in enumerate(Qs):
            m_d = Qd.shape[0]
            i0 = self.iw.idx[d_]
            i1 = torch.clamp(i0 + 1, max=m_d - 1)
            w2 = self.iw.w[d_]
            Pd = w2[:, 0:1] * Qd[i0, :] + w2[:, 1:2] * Qd[i1, :]  # W_d Q_d
            col = Pd[:, idx[:, d_]]  # (n, r)
            U0 = col if U0 is None else U0 * col
        return lowrank_spectral_factor(U0, weights=lam_r)

    # -- lattice dual (Woodbury) --------------------------------------------------

    def _lattice_cbar(self) -> float:
        """Mean of ``diag(WᵀW)``, the scalar shift of the closed-form whitener."""
        if not hasattr(self, "_cbar"):
            self._cbar = lattice_cbar(self._iw_np, stream=self._cstream)
        return self._cbar

    def _lattice_spectra(self, factors, sigma2):
        """Closed-form pieces of the lattice dual ``B = σ²K⁻¹ + WᵀW``:

            yᵀÂ⁻¹y = (yᵀy − (Wᵀy)ᵀ B⁻¹ (Wᵀy)) / σ²
            log|Â|  = (n−M)·log σ² + Σ_j log(σ² + c̄λ_j) + log|W̃|

        with the whitener ``M = σ²K⁻¹ + c̄I`` exact in the Kronecker eigenbasis
        (``M^{−1/2} = Q diag(√(λ/(σ²+c̄λ))) Qᵀ``) and ``W̃ = M^{−1/2} B M^{−1/2}``.
        Returns ``(Qs, wjs, ld_MK)``: sign-canonical per-dimension
        eigenvectors, the ``(M,)`` eigen-scales and ``Σ log(σ² + c̄λ)``."""
        cbar = self._lattice_cbar()
        Qs, lams = _kron_eigh_canonical(factors)
        lam = lam_kron(_clamp_psd(lams))
        wjs = torch.sqrt(lam / (sigma2 + cbar * lam))
        ld_MK = torch.sum(torch.log(sigma2 + cbar * lam))
        return Qs, wjs, ld_MK

    def _wtw_bm_op(self):
        """Batch-major ``WᵀW`` ``(B, M) → (B, M)``: the stencil (K5 on the
        card), else ``Wᵀ(W v)`` through the interpolation plan."""
        if self._wtw_op is not None:
            return self._wtw_op
        return lambda v_bm: self._rmatvec_bm(self._w_bm(v_bm))

    def _lattice_precision(self) -> str:
        """The Q/Qᵀ applies' precision: the X3 preset on the card (exact f32,
        K2/K3 where the gates send it), else exact."""
        return X3 if self._lattice_x3 and self.device.type == "cuda" else "highest"

    def _make_lattice_ops(self, Qs, wjs, mixed16: bool = False):
        """Batch-major ``(B, M)`` closures ``(to_dual, from_dual, white)`` with
        the whitened dual in the Kronecker eigenbasis (``D = diag(wjs)``):

        - ``to_dual(u) = D ⊙ (Qᵀu)``;
        - ``from_dual(ṽ) = Q(D ⊙ ṽ)``;
        - ``white(ṽ) = ṽ + to_dual(WᵀW·u − c̄·u)``, ``u = from_dual(ṽ)``.

        ``mixed16`` hands each Kronecker matvec a bf16 input (K2's bf16
        member on the card) and returns it in ``wjs``'s dtype; the diagonal
        scalings and ``WᵀW`` stay in that dtype (JAX ``gp_ski.py:498-562``).
        """
        cbar = self._lattice_cbar()
        Qs = tuple(Q.contiguous() for Q in Qs)
        QsT = tuple(Q.T.contiguous() for Q in Qs)
        prec = self._lattice_precision()
        wd = wjs.dtype
        mv_in = (lambda t: t.to(torch.bfloat16)) if mixed16 else (lambda t: t)

        def kron(fs, t, B):
            eyeB = batch_identity(B, dtype=wd, device=t.device)
            return kron_matvec_fast((eyeB, *fs), mv_in(t), precision=prec).reshape(B, -1).to(wd)

        def to_dual(v_bm):
            B = v_bm.shape[0]
            return kron(QsT, v_bm.reshape(-1), B) * wjs[None, :]

        def from_dual(v_bm):
            B = v_bm.shape[0]
            return kron(Qs, (v_bm * wjs[None, :]).reshape(-1), B)

        wtw = self._wtw_bm_op()

        def white(v_bm):
            u = from_dual(v_bm)
            return v_bm + to_dual(wtw(u) - cbar * u)

        return to_dual, from_dual, white

    def _solve_bm_lattice(self, factors, sigma2, rhs_bm):
        """Data-space solve through the whitened dual:
        ``Â⁻¹r = (r − W M^{-1/2} W̃⁻¹ M^{-1/2} Wᵀ r)/σ²``."""
        o = self._opts
        Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
        to_dual, from_dual, white = self._make_lattice_ops(Qs, wjs)
        u = to_dual(self._rmatvec_bm(rhs_bm))
        gam, self.cg_info = cg_solve(white, u, tol=o["cg_tol"], max_iters=o["cg_iters"], layout="bm",
                                     return_info=True, implicit_diff=False)
        return (rhs_bm - self._w_bm(from_dual(gam))) / sigma2

    # -- solves ---------------------------------------------------------------------

    def _solve_bm(self, factors, sigma2, rhs_bm, pre=None):
        """Batch-major CG solve of ``(K̂+σ²I) X = rhs`` (``rhs_bm (B, n)``),
        honouring ``cg_precision`` and the deflation preconditioner (``pre``
        shares one built preconditioner between calls).  With a
        preconditioner the solve runs whitened (``Â⁻¹r = M⁻½W̃⁻¹M⁻½r``):
        data-space PCG freezes whenever σ² < ε_f32·λmax."""
        o = self._opts
        if self.solver == "lattice":
            return self._solve_bm_lattice(factors, sigma2, rhs_bm)
        if pre is None:
            pre = self._build_precond(factors, sigma2)
        mv = self._matvec_bm(factors, sigma2)
        _w = pre[1] if pre is not None else (lambda v: v)
        if o["cg_precision"] == "mixed":
            mv_fast = self._matvec_bm(factors, sigma2, precision="default")
            solw, self.cg_info = cg_solve_refined(
                lambda vv: _w(mv_fast(_w(vv))), lambda vv: _w(mv(_w(vv))), _w(rhs_bm),
                tol=max(o["cg_tol"], 1e-7), inner_iters=50, max_restarts=max(1, o["cg_iters"] // 50),
                layout="bm", return_info=True, implicit_diff=False,
            )
        else:
            solw, self.cg_info = cg_solve(
                lambda vv: _w(mv(_w(vv))), _w(rhs_bm), tol=o["cg_tol"], max_iters=o["cg_iters"],
                layout="bm", return_info=True, implicit_diff=False,
            )
        return _w(solw)

    def _solve(self, factors, sigma2, rhs, pre=None):
        """Column-layout solve (``(n,)`` / ``(n, B)`` right-hand sides)."""
        if rhs.ndim == 1:
            return self._solve_bm(factors, sigma2, rhs[None, :], pre=pre)[0]
        return self._solve_bm(factors, sigma2, rhs.T.contiguous(), pre=pre).T

    def kernel_matvec(self, v):
        """``(K̂ + σ²I) v`` at the current parameters."""
        with torch.no_grad():
            return self._matvec(self._factors(), torch.exp(self.log_noise))(v)

    # -- NLML and its surrogate gradient -------------------------------------------

    def _surrogate(self, value, g_sur):
        """``value`` with the surrogate ``g_sur()``'s gradient attached
        (``value + g − stop_gradient(g)``), built only when a gradient is
        needed; ``value=None`` (the SLQ skipped) leaves ``g`` itself."""
        if value is not None and not self._needs_grad():
            return value
        g = g_sur()
        return g if value is None else value + g - g.detach()

    def _data_objective(self, mv, sol, z, ld):
        """The data solver's NLML from its solves ``sol = [α; S]`` (``S`` the
        probe solves ``A⁻¹z``): ``quad = 2yᵀα − αᵀAα``, exact in value and
        gradient at the solution, and ``log|A|`` (value ``ld``) with the
        Hutchinson surrogate ``Σ S ⊙ A z / R``."""
        alpha = sol[0]
        quad = 2.0 * torch.dot(self.y, alpha) - torch.dot(alpha, mv(alpha[None, :])[0])
        ld = self._surrogate(ld, lambda: torch.sum(sol[1:] * mv(z)) / z.shape[0])
        return 0.5 * (quad + ld + self.n * math.log(2.0 * math.pi))

    def _lattice_terms(self, factors, sigma2):
        """``(white, ṽ, Σ log(σ² + c̄λ))``: the whitened dual's operator, its
        right-hand side ``ṽ = D·Qᵀ(Wᵀy)`` and the closed-form log-det term."""
        Qs, wjs, ld_MK = self._lattice_spectra(factors, sigma2)
        to_dual, _, white = self._make_lattice_ops(Qs, wjs)
        return white, to_dual(self._rmatvec_bm(self.y[None, :])), ld_MK

    def _lattice_objective(self, sigma2, white, vt, ld_MK, sol, z, ld_white):
        """The lattice dual's NLML from its solves ``sol = [γ; S]``: the
        closed-form terms differentiate exactly, ``log|W̃|`` (value
        ``ld_white``) carries the Hutchinson surrogate ``Σ S ⊙ W̃z / R``."""
        gam = sol[0]
        quad = _dual_quad(torch.dot(self.y.double(), self.y.double()), vt[0], gam, white, sigma2)
        ld_white = self._surrogate(ld_white, lambda: torch.sum(sol[1:] * white(z)) / z.shape[0])
        ld = (self.n - self.M) * self.log_noise + ld_MK + ld_white
        return 0.5 * (quad + ld + self.n * math.log(2.0 * math.pi))

    def _loss(self) -> torch.Tensor:
        """Negative log marginal likelihood with the BBMM surrogate gradient
        (JAX ``gp_ski.py:711-757``).  The Hutchinson probe solves stay in the
        batch (``1 + num_probes`` right-hand sides), so the CG runs the JAX
        package's iterations; the solves, the preconditioner and the SLQ
        value run without a graph, and the surrogate is built only when a
        gradient is needed."""
        if self.solver == "lattice":
            return self._loss_lattice()
        o = self._opts
        n = self.n
        sigma2 = torch.exp(self.log_noise)
        factors = self._factors()
        mv = self._matvec_bm(factors, sigma2)
        gen = self._generator()
        z = _lz.rademacher((o["num_probes"], n), dtype=self.dtype, device=self.device, generator=gen)
        with torch.no_grad():
            pre = self._build_precond(factors, sigma2)
            sol = self._solve_bm(factors, sigma2, torch.cat([self.y[None, :], z], dim=0), pre=pre)
            # SLQ on the exact operator, whitened when deflated:
            # log|A| = log|M| + log|M⁻½AM⁻½|.
            if pre is not None:
                M_inv_sqrt, ld_off = pre[1], pre[2]
                slq_mv = lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))  # noqa: E731
            else:
                slq_mv, ld_off = mv, 0.0
            ld = ld_off + _lz.slq_logdet(
                slq_mv, n, generator=gen, num_probes=o["num_probes"], lanczos_iters=o["lanczos_iters"],
                dtype=self.dtype, device=self.device, layout="bm",
            )
        return self._data_objective(mv, sol, z, ld)

    def _loss_lattice(self) -> torch.Tensor:
        """NLML through the lattice dual (see :meth:`_lattice_spectra`), with
        the surrogate of :meth:`_lattice_objective` (JAX ``gp_ski.py:577-620``)."""
        o = self._opts
        sigma2 = torch.exp(self.log_noise)
        white, vt, ld_MK = self._lattice_terms(self._factors(), sigma2)
        gen = self._generator()
        z = _lz.rademacher((o["num_probes"], self.M), dtype=self.dtype, device=self.device, generator=gen)
        with torch.no_grad():
            sol, self.cg_info = cg_solve(white, torch.cat([vt, z], dim=0), tol=o["cg_tol"],
                                         max_iters=o["cg_iters"], layout="bm", return_info=True,
                                         implicit_diff=False)
            ld_white = _lz.slq_logdet(
                white, self.M, generator=gen, num_probes=o["num_probes"], lanczos_iters=o["lanczos_iters"],
                dtype=self.dtype, device=self.device, layout="bm",
            )
        return self._lattice_objective(sigma2, white, vt, ld_MK, sol, z, ld_white)

    # -- the host drivers ------------------------------------------------------------

    def _data_op(self, factors, sigma2):
        """The data solver's working operator ``(op, M^{-1/2} or None, log|M|)``:
        ``M^{-1/2} A M^{-1/2}`` with the rank-r deflation, else ``A``."""
        mv = self._matvec_bm(factors, sigma2)
        pre = self._build_precond(factors, sigma2)
        if pre is None:
            return mv, None, 0.0
        w = pre[1]
        return (lambda vv: w(mv(w(vv)))), w, pre[2]

    def _step_solves(self, generator, R: int, segment_iters: int):
        """One training step's solves, without a graph: ``(sol (1+R, dim),
        z (R, dim), iterations)``, the y-solve and the ``R`` probe solves in
        the solver's working space (γ's of the lattice dual, or ``α``'s of
        the data solver, solved whitened with the deflation), by
        :func:`~gp_grief_tpu_torch.ops.cg.cg_segments` with its stagnation
        stop.  ``train_mixed16`` runs the lattice solves with bf16 state and
        bf16 Kronecker inputs (JAX ``gp_ski.py:1187-1334``)."""
        o = self._opts
        lattice = self.solver == "lattice"
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            factors = self._factors()
            z = _lz.rademacher((R, self.M if lattice else self.n), dtype=self.dtype, device=self.device,
                               generator=generator)
            unwhiten = None
            if lattice:
                Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
                to_dual, _, op = self._make_lattice_ops(Qs, wjs)
                rhs = torch.cat([to_dual(self._rmatvec_bm(self.y[None, :])), z], dim=0)
                if self._train_mixed16:
                    op = self._make_lattice_ops(Qs, wjs, mixed16=True)[2]
            else:
                op, unwhiten, _ = self._data_op(factors, sigma2)
                rhs = torch.cat([self.y[None, :], z], dim=0)
                if unwhiten is not None:
                    rhs = unwhiten(rhs)
            mixed = lattice and self._train_mixed16
            x, iters = cg_segments(op, rhs, tol=o["cg_tol"], max_iters=o["cg_iters"],
                                   segment_iters=int(segment_iters),
                                   state_dtype=torch.bfloat16 if mixed else None)
            sol = unwhiten(x) if unwhiten is not None else x
        return sol, z, iters

    def _step_objective(self, sol, z) -> torch.Tensor:
        """The surrogate objective with one step's solves injected: the NLML
        less its log-det value, whose gradient is ``jax.grad(self._loss)``'s
        at matching probes (JAX ``optimize_segmented``'s ``surrogate``)."""
        sigma2 = torch.exp(self.log_noise)
        factors = self._factors()
        if self.solver == "lattice":
            white, vt, ld_MK = self._lattice_terms(factors, sigma2)
            return self._lattice_objective(sigma2, white, vt, ld_MK, sol, z, None)
        return self._data_objective(self._matvec_bm(factors, sigma2), sol, z, None)

    def optimize_segmented(
        self,
        *,
        max_iters: int = 30,
        learning_rate: float = 0.05,
        num_probes: int = 4,
        cg_segment_iters: int = 50,
        verbose: bool = False,
        callback=None,
    ) -> FitResult:
        """Adam training one step at a time, for large ``n``:

        1. the y-solve and ``num_probes`` probe solves, without a graph, in
           the solver's working space (:meth:`_step_solves`), the probes
           fresh each step from ``(seed, 1000 + step)``;
        2. the surrogate objective with those solves injected, and its
           gradient by autograd (the SLQ value is skipped);
        3. a ``torch.optim.Adam`` update.

        Parameters held by :meth:`fix` get a zero gradient.  ``callback(step,
        surrogate, info)``, called after each update, gets ``info`` with the
        step's ``cg_iterations``.  Under a profiler each step is the span
        ``gp_grief.model.step`` with its ``.solve`` and ``.grad``
        (:mod:`~gp_grief_tpu_torch.utils.profiling`).  Returns a
        :class:`~gp_grief_tpu_torch.optimize.FitResult` whose ``losses`` are
        the surrogate objective (its trend is meaningful, its level is not:
        :meth:`log_likelihood_segmented` gives the NLML) and whose
        ``grad_norms`` are NaN, as in the JAX package.
        """
        if self.solver == "lattice":
            self._lattice_cbar()
        named = list(self._leaves())
        params = [p for _, p in named]
        fixed = self._fixed_mask() or {}
        frozen = [p for name, p in named if fixed.get(name, False)]
        opt = torch.optim.Adam(params, lr=learning_rate, eps=1e-8)
        losses = []
        t0 = time.perf_counter()
        for it in range(int(max_iters)):
            with _step_span(it):
                with _step_solve_span():
                    sol, z, iters = self._step_solves(self._generator(it), int(num_probes), cg_segment_iters)
                self.cg_iterations = iters
                with _step_grad_span():
                    opt.zero_grad(set_to_none=True)
                    val = self._step_objective(sol, z)
                    val.backward()
                    for p in frozen:
                        if p.grad is not None:
                            p.grad.zero_()
                    with _prof.host_read("model.step.loss"):
                        losses.append(float(val.detach()))
                opt.step()
            if verbose:
                print(f"[optimize_segmented] iter {it + 1:3d} surrogate {losses[-1]:.4f} "
                      f"({iters} CG iterations)", flush=True)
            if callback is not None:
                callback(it, losses[-1], {"cg_iterations": iters})
        return FitResult(
            losses=np.asarray(losses), grad_norms=np.full(len(losses), np.nan), iterations=len(losses),
            wall_time=time.perf_counter() - t0, converged=False, opt_state=opt.state_dict(),
        )

    def log_likelihood_segmented(
        self,
        *,
        cg_segment_iters: int = 60,
        probe_chunk: int = 8,
        fuse_probes: bool = True,
        verbose: bool = False,
    ) -> float:
        """Log marginal likelihood by the fused CG + SLQ host driver
        (:func:`~gp_grief_tpu_torch.ops.fused.fused_cg_slq`): the SLQ probes
        in chunks of ``probe_chunk``, each chunk's ``lanczos_iters`` steps
        also advancing the y-solve with ``fuse_probes``, then CG segments of
        ``cg_segment_iters`` to the tolerance, with the Gauss quadrature in
        float64 on the host.  The estimator of :meth:`log_likelihood` (JAX
        ``gp_ski.py:759-868``); its probes are drawn chunk by chunk from the
        model's generator, so the two agree within SLQ sampling error.
        Value only."""
        o = self._opts
        lattice = self.solver == "lattice"
        with torch.no_grad(), _nlml_span():
            sigma2 = torch.exp(self.log_noise)
            factors = self._factors()
            if lattice:
                op, rhs, ld_MK = self._lattice_terms(factors, sigma2)
                unwhiten, ld_off = None, None
            else:
                op, unwhiten, ld_off = self._data_op(factors, sigma2)
                rhs = self.y[None, :] if unwhiten is None else unwhiten(self.y[None, :])
            x, ld_white, iters = fused_cg_slq(
                op, rhs, generator=self._generator(), num_probes=o["num_probes"],
                lanczos_iters=o["lanczos_iters"], probe_chunk=probe_chunk, cg_tol=o["cg_tol"],
                cg_iters=o["cg_iters"], cg_segment_iters=cg_segment_iters, fuse_probes=fuse_probes,
                verbose=verbose,
            )
            self.cg_iterations = iters
            if lattice:
                nlml = self._lattice_objective(sigma2, op, rhs, ld_MK, x, None, ld_white)
            else:
                alpha = x if unwhiten is None else unwhiten(x)
                nlml = self._data_objective(self._matvec_bm(factors, sigma2), alpha, None, ld_off + ld_white)
            with _prof.host_read("model.nlml"):
                return -float(nlml)

    # -- prediction --------------------------------------------------------------------

    @staticmethod
    def _prior_diag(factors, iw_c):
        """Diagonal of the SKI prior at test points, factorized over
        dimensions: ``Π_d Σ_{o,o'} w_d[t,o]·K_d[i+o, i+o']·w_d[t,o']``."""
        prior = None
        for d_, Kd in enumerate(factors):
            m_d = Kd.shape[0]
            i0 = iw_c.idx[d_]
            w2 = iw_c.w[d_]
            s = None
            for a in (0, 1):
                for b in (0, 1):
                    ia = torch.clamp(i0 + a, max=m_d - 1)
                    ib = torch.clamp(i0 + b, max=m_d - 1)
                    term = w2[:, a] * Kd[ia, ib] * w2[:, b]
                    s = term if s is None else s + term
            prior = s if prior is None else prior * s
        return prior

    @_prof.spanned("gp_grief.model.predict.prep")
    def _predict_prep(self, factors, sigma2, variance: str, compute_var: bool, var_rank: int) -> dict:
        """The per-prediction precomputation: the mean representer
        ``K Wᵀ Â⁻¹ y`` and, for LOVE, the projected Krylov basis ``S`` and
        the Cholesky factor of ``T``."""
        o = self._opts
        prep = {"factors": factors, "sigma2": sigma2, "S": None, "Tchol": None}
        love = variance == "lanczos" and compute_var
        if self.solver == "lattice":
            # The mean representer without the data-space correction:
            # K Wᵀ Â⁻¹ y ≡ B⁻¹ (Wᵀy); the data-space form cancels
            # catastrophically in float32 when σ² ≪ κ(K̂)·ε.
            Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
            to_dual, from_dual, white = self._make_lattice_ops(Qs, wjs)
            prep["ops"] = (to_dual, from_dual, white)
            vt = to_dual(self._rmatvec_bm(self.y[None, :]))
            gam = cg_solve(white, vt, tol=o["cg_tol"], max_iters=o["cg_iters"], layout="bm")
            prep["Kw_alpha"] = from_dual(gam)[0]
            if not love:
                return prep
            res = _lz.lanczos(lambda v: white(v.T.contiguous()).T, vt[0], var_rank, full_reorth=True,
                              store_basis=True)
            S = res.Q.T  # (r, M) whitened-dual Krylov basis
        else:
            prep["pre"] = pre = self._build_precond(factors, sigma2)
            alpha = self._solve(factors, sigma2, self.y, pre=pre)
            prep["Kw_alpha"] = kron_matvec_fast(factors, self._rmatvec_bm(alpha[None, :])[0], precision="highest")
            if not love:
                return prep
            res = _lz.lanczos(self._matvec(factors, sigma2), self.y, var_rank, full_reorth=True, store_basis=True)
            QW = self._rmatvec_bm(res.Q.T.contiguous())  # (r, M)
            eyeR = batch_identity(var_rank, dtype=self.dtype, device=self.device)
            S = kron_matvec_fast((eyeR, *factors), QW.reshape(-1), precision="highest").reshape(var_rank, -1)
        # Dense T; identity rows past breakdown (their Q columns are zero).
        valid = torch.arange(var_rank, device=self.device) < res.num_valid
        diag = torch.where(valid, res.alpha, torch.ones_like(res.alpha))
        T = torch.diag(diag) + torch.diag(res.beta, 1) + torch.diag(res.beta, -1)
        prep.update(S=S, Tchol=cholesky(T))
        return prep

    @_prof.spanned("gp_grief.model.predict.chunk")
    def _predict_chunk(self, prep: dict, variance: str, compute_var: bool, xc):
        """Mean and variance of one chunk of test points."""
        o = self._opts
        factors, S, Tchol = prep["factors"], prep["S"], prep["Tchol"]
        iw_c = interp_weights(xc, self.xg)
        mean = interp_matvec(iw_c, prep["Kw_alpha"])  # k̂(x*, X) α = W* K (Wᵀ α)
        if not compute_var:
            return mean, torch.zeros_like(mean)
        prior_diag = self._prior_diag(factors, iw_c)
        c = int(xc.shape[0])
        eyeC = batch_identity(c, dtype=self.dtype, device=self.device)
        Wst_bm = interp_rmatvec_bm(iw_c, eyeC)  # (c, M) test interpolation rows w*_t
        if self.solver == "lattice":
            to_dual, from_dual, white = prep["ops"]
            wtw = self._wtw_bm_op()
            if variance == "lanczos":
                # Dual LOVE, the whitener as the off-span inverse:
                # W̃⁻¹ ≈ I + Q̃(T⁻¹ − I)Q̃ᵀ; reduction = u2·u1 + p2ᵀT⁻¹p1 − p2ᵀp1
                # with u1 = to_dual(w*), u2 = to_dual(GKw*), p = Q̃ᵀu.
                u1 = to_dual(Wst_bm)
                KW = kron_matvec_fast((eyeC, *factors), Wst_bm.reshape(-1), precision="highest").reshape(c, -1)
                u2 = to_dual(wtw(KW))
                proj1, proj2 = u1 @ S.T, u2 @ S.T
                Z1 = torch.linalg.solve_triangular(Tchol, proj1.T, upper=False)
                Z2 = torch.linalg.solve_triangular(Tchol, proj2.T, upper=False)
                var = prior_diag - (torch.sum(u1 * u2, dim=1) + torch.sum(Z1 * Z2, dim=0)
                                    - torch.sum(proj1 * proj2, dim=1))
                return mean, torch.clamp_min(var, 0.0)
            # Exact, in the whitened dual: c_tᵀÂ⁻¹c_t ≡ w*ᵀ K (WᵀW) B⁻¹ w*.
            gam = cg_solve(white, to_dual(Wst_bm), tol=o["cg_tol"], max_iters=o["cg_iters"], layout="bm")
            Ggam = wtw(from_dual(gam))
            KG = kron_matvec_fast((eyeC, *factors), Ggam.reshape(-1), precision="highest").reshape(c, -1)
            var = prior_diag - torch.sum(Wst_bm * KG, dim=1)
            return mean, torch.clamp_min(var, 0.0)
        if variance == "lanczos":
            G = interp_matvec_bm(iw_c, S)  # (r, c): g_t = Qᵀ c_t = S w*_t
            Z = torch.linalg.solve_triangular(Tchol, G, upper=False)
            var = prior_diag - torch.sum(Z * Z, dim=0)
            return mean, torch.clamp_min(var, 0.0)
        # Exact: c_t = k̂(X, x*_t); var_t = k̂** − c_tᵀ Ã⁻¹ c_t.
        u = kron_matvec_fast((eyeC, *factors), Wst_bm.reshape(-1), precision="highest")
        C_bm = interp_matvec_bm_fast(self._plan, u.reshape(c, -1))  # (c, n)
        Sol = self._solve_bm(factors, prep["sigma2"], C_bm, pre=prep["pre"])
        var = prior_diag - torch.sum(C_bm * Sol, dim=1)
        return mean, torch.clamp_min(var, 0.0)

    @_prof.spanned("gp_grief.model.predict", entry=True)
    def predict(
        self,
        x_new,
        compute_var: bool = True,
        include_noise: bool = False,
        chunk: int = 0,
        variance: str = "exact",
        var_rank: int = 100,
        love_check: int = 8,
        love_tol: float = 0.1,
        love_on_fail: str = "exact",
    ):
        """Predictive mean (and variance) at ``x_new``; tensors on the model's
        device.

        ``variance="exact"`` solves against the cross-covariance columns of
        one chunk of test points at a time (``chunk=0`` sizes it from
        ``n + m``), in a plain host loop.  ``variance="lanczos"`` is LOVE: one
        ``var_rank``-step fully reorthogonalized Lanczos run gives
        ``Ã⁻¹ ≈ Q T⁻¹ Qᵀ`` on the Krylov space, and each chunk interpolates the
        precomputed ``(r, M)`` rows.  Under ``solver='lattice'`` both run in
        the whitened dual.  LOVE variances are checked on the first
        ``love_check`` test points against the exact route; a relative
        deviation above ``love_tol`` triggers ``love_on_fail``: ``"exact"``
        (warn and return the exact prediction), ``"warn"`` (warn and return
        LOVE's) or ``"raise"`` (``RuntimeError``).
        """
        if variance not in ("exact", "lanczos"):
            raise ValueError("variance must be 'exact' or 'lanczos'")
        if love_on_fail not in ("exact", "warn", "raise"):
            raise ValueError("love_on_fail must be 'exact', 'warn' or 'raise'")
        x_new = (x_new.to(dtype=self.dtype, device=self.device) if isinstance(x_new, torch.Tensor)
                 else torch.as_tensor(np.asarray(x_new), dtype=self.dtype, device=self.device))
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        n_star = int(x_new.shape[0])
        if n_star == 0:
            empty = torch.zeros((0,), dtype=self.dtype, device=self.device)
            return empty if not compute_var else (empty, empty.clone())
        n, m = self.n, self.M
        var_rank = int(min(var_rank, m if self.solver == "lattice" else n))
        if chunk <= 0:
            if variance == "lanczos" and compute_var:
                chunk = int(max(1, min(n_star, 4096)))
            else:
                chunk = int(max(1, min(n_star, max(8, (1 << 26) // max(n + m, 1)))))
        chunk = min(chunk, n_star)
        n_pad = -(-n_star // chunk) * chunk
        x_pad = x_new
        if n_pad != n_star:  # pad with copies of the first point
            x_pad = torch.cat([x_new, x_new[:1].expand(n_pad - n_star, x_new.shape[1])])
        guard_k = int(min(love_check, n_star)) if (variance == "lanczos" and compute_var) else 0
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            prep = self._predict_prep(self._factors(), sigma2, variance, compute_var, var_rank)
            means, vars_ = [], []
            for i in range(0, n_pad, chunk):
                mc, vc = self._predict_chunk(prep, variance, compute_var, x_pad[i : i + chunk])
                means.append(mc)
                vars_.append(vc)
            mean = torch.cat(means)[:n_star]
            var = torch.cat(vars_)[:n_star]
            if guard_k > 0:
                _, v_exact = self._predict_chunk(prep, "exact", True, x_new[:guard_k])
                with _prof.host_read("model.predict.love_check", 2):
                    v_exact, v_love = v_exact.cpu().numpy(), var[:guard_k].cpu().numpy()
                # Denominator floor at 1% of the sample's largest variance: a
                # denormal-tiny exact variance must not turn a negligible
                # absolute deviation into an astronomic ratio.
                vmax = float(max(np.max(v_exact), np.max(v_love), 0.0))
                floor = max(1e-2 * vmax, float(np.finfo(v_exact.dtype).tiny))
                rel = float(np.max(np.abs(v_love - v_exact) / np.maximum(np.abs(v_exact), floor)))
                if rel > love_tol:
                    msg = (f"LOVE (variance='lanczos', var_rank={var_rank}) variance deviates from the exact "
                           f"route by up to {rel:.1%} on {guard_k} sampled test points (tolerance {love_tol:.0%})")
                    if love_on_fail == "raise":
                        raise RuntimeError(msg + " — use variance='exact' or raise var_rank.")
                    if love_on_fail == "exact":
                        warnings.warn(msg + " — auto-upgrading to the exact variance route "
                                      "(love_on_fail='exact').", stacklevel=2)
                        return self.predict(x_new, compute_var=compute_var, include_noise=include_noise,
                                            chunk=0, variance="exact")
                    warnings.warn(msg + " — use variance='exact' or raise var_rank.", stacklevel=2)
            if not compute_var:
                return mean
            if include_noise:
                var = var + sigma2
        return mean, var
