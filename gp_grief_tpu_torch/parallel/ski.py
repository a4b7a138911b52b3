"""Data-parallel SKI regression: sharded interpolation rows, replicated lattice.

Counterpart of ``gp_grief_tpu.parallel.ski``.  SKI's O(n) work is the
interpolation ``W`` / ``Wᵀ`` and the CG/SLQ state of the data solver; both
shard over the ``data`` axis while the lattice (``⊗_d K_d``, size M) stays
replicated.  Rank k holds rows x_k, y_k and the interpolation plan of its
own rows (built on the host):

    Wᵀ v  =  Σ_k Wᵀ_k v_k      → kernel K4 per rank, one (B, M) psum
    ⊗K_d  matvec               → replicated
    W u                         → the rank's rows (gather, K4 its adjoint)
    CG / Lanczos inner products → all-reduced (the solvers' ``group=``)

The lattice dual keeps its state replicated; its ``ŴᵀŴ`` is a stencil built
from each rank's own rows (kernel K5 per rank) and one ``psum`` per apply.
The data solver's rank-r deflation is built sharded too: each rank holds its
rows of the skinny basis ``U (n, r)`` and the CholeskyQR2 Grams are r×r
psums.

Padding: rows are zero-padded to the axis size with a row mask applied as a
congruence (``Â = mask∘(W K Wᵀ)∘mask + σ²I``), which decouples pad rows (they
see a pure σ² identity); the log-det correction ``−(n_pad−n)·log σ²`` and
masked probes make every NLML quantity exactly the real-data one.

Departures from the JAX package: no windowed interpolation plans (the port
runs K4 in every regime); the lattice's ``ŴᵀŴ`` stencil is per rank and
psum-coupled, not replicated from all rows; each rank draws the data
solver's probes from its own generator (JAX folds the device index into
its key); ``predict`` takes only the exact variance, as the JAX sharded
model does.  Gradients follow ``ops.collectives``' convention.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from gp_grief_tpu_torch.kernels.stationary import Stationary
from gp_grief_tpu_torch.models.base import check_xy, resolve_device
from gp_grief_tpu_torch.models.gp_grief import _resolve_dtype
from gp_grief_tpu_torch.models.gp_ski import (
    TIE_QUANTUM,
    GPSKIRegression,
    _dual_quad,
    _kron_eigh_canonical,
    _timed_plan,
    warn_lattice_small_n,
)
from gp_grief_tpu_torch.ops import lanczos as _lz
from gp_grief_tpu_torch.ops.cg import cg_segments, cg_solve, cg_solve_refined
from gp_grief_tpu_torch.ops.fused import fused_cg_slq
from gp_grief_tpu_torch.ops.interp import build_corner_stream, build_interp_plan, interp_weights
from gp_grief_tpu_torch.ops.interp_stencil import build_wtw_stencil
from gp_grief_tpu_torch.ops.kron_fast import batch_identity, kron_matvec_fast
from gp_grief_tpu_torch.ops.solve import stable_cholesky
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs
from gp_grief_tpu_torch.ops.collectives import axis_index, axis_size, psum, replicate
from gp_grief_tpu_torch.parallel.mesh import data_mesh
from gp_grief_tpu_torch.parallel.sharded import local_rows, pad_to_multiple

__all__ = ["ShardedGPSKIRegression", "build_sharded_interp"]


def build_sharded_interp(x_pad: np.ndarray, xg, n_devices: int, *, rank: Optional[int] = None, dtype=None,
                         device=None):
    """Per-rank interpolation plans of the padded rows ``x_pad``, split into
    ``n_devices`` equal blocks: a list of every block's
    :class:`~gp_grief_tpu_torch.ops.interp.InterpPlan`, or with ``rank`` that
    block's alone (what a rank of a sharded model builds).  The JAX package
    stacks the blocks' plans for ``shard_map``; here each rank keeps its own,
    so nothing is padded to common extents."""
    n_pad = x_pad.shape[0]
    if n_pad % n_devices:
        raise ValueError(f"{n_pad} rows do not split over {n_devices} ranks")
    n_loc = n_pad // n_devices
    xg_np = [np.asarray(g).reshape(-1) for g in xg]

    def plan(k):
        iw = interp_weights(np.asarray(x_pad[k * n_loc : (k + 1) * n_loc]), xg_np)
        return build_interp_plan(iw, dtype=dtype, device=device)

    return plan(rank) if rank is not None else [plan(k) for k in range(n_devices)]


def _sharded_spectral_factor(U0: torch.Tensor, weights: torch.Tensor, group):
    """Row-sharded ``ops.precond.lowrank_spectral_factor`` (CholeskyQR2, then
    the r×r congruence ``eigh``): the two Gram reductions are psums, the
    small factorizations run replicated."""
    Ut, Ls = U0, []
    for _ in range(2):
        L, _ = stable_cholesky(psum(Ut.T @ Ut, group))
        Ut = torch.linalg.solve_triangular(L.T, Ut, upper=True, left=False)
        Ls.append(L)
    mid = (Ls[1].T @ Ls[0].T) * torch.sqrt(weights)[None, :]
    s, V = torch.linalg.eigh(mid @ mid.T)
    return Ut @ V, torch.clamp_min(s, 0.0)


def _sharded_lowrank_ops(U: torch.Tensor, lam: torch.Tensor, sigma2, n_pad: int, group):
    """Row-sharded ``ops.precond.lowrank_sqrt_ops(layout="bm")``: ``U`` holds
    this rank's rows of the orthonormal basis; the r-vector contraction is one
    psum.  Returns ``(M_inv, M_inv_sqrt, logdet_M)`` of the padded operator."""
    lam_shift = lam + sigma2

    def _apply(diag_fun):
        base = diag_fun(sigma2)
        delta = diag_fun(lam_shift) - base

        def op(v):
            return base * v + (psum(v @ U, group) * delta[None, :]) @ U.T

        return op

    logdet_M = torch.sum(torch.log(lam_shift)) + (n_pad - lam.shape[0]) * torch.log(sigma2)
    return _apply(lambda s: 1.0 / s), _apply(lambda s: 1.0 / torch.sqrt(s)), logdet_M


class ShardedGPSKIRegression(GPSKIRegression):
    """Data-parallel :class:`~gp_grief_tpu_torch.models.gp_ski.GPSKIRegression`,
    one rank of it.

    The same estimator (deflation-whitened CG and SLQ with the BBMM
    surrogates, or the whitened lattice dual), with the n-axis sharded over
    ``axis_name`` of ``mesh`` (a ``DeviceMesh``; default a 1-D data mesh over
    every rank): every rank constructs it from the same full data and keeps
    its block of the padded rows.  ``log_likelihood``, ``optimize``,
    ``optimize_segmented``, ``log_likelihood_segmented`` and ``predict``
    (exact variance) run SPMD: every rank calls them together and gets the
    same numbers.  The parameters carry the single-device model's leaf names.

    ``seed`` seeds the probes: the lattice dual's, replicated, as the
    single-device model draws them; the data solver's per rank (each rank
    draws its rows of every probe)."""

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
        seed: int = 0,
        mesh=None,
        axis_name: str = "data",
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        device = resolve_device(x, device)
        dtype = _resolve_dtype(x, dtype)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64

        def _np(a):
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            return a.astype(np_dtype)

        x_np, y_np = (t.numpy() for t in check_xy(torch.as_tensor(_np(x)), torch.as_tensor(_np(y))))
        if grid is None:
            from gp_grief_tpu_torch.grid import InducingGrid

            grid = InducingGrid.build(x_np, mbar=mbar)
        mesh = mesh if mesh is not None else data_mesh(axis_name=axis_name, device_type=device.type)
        w = axis_size(mesh, axis_name)
        xp, mask = pad_to_multiple(x_np, w)
        yp, _ = pad_to_multiple(y_np, w)
        rows = local_rows(xp.shape[0], mesh, axis_name)
        with warnings.catch_warnings():
            # The small-n warning is about the whole data set (below).
            warnings.simplefilter("ignore")
            super().__init__(
                xp[rows], yp[rows], kern_list, grid, noise_var=noise_var, dim_noise_var=dim_noise_var,
                num_probes=num_probes, lanczos_iters=lanczos_iters, cg_tol=cg_tol, cg_iters=cg_iters,
                cg_precision=cg_precision, precond_rank=precond_rank, solver=solver, wtw_stencil=wtw_stencil,
                lattice_x3=lattice_x3, seed=seed, dtype=dtype, device=device,
            )
        if solver == "lattice":
            warn_lattice_small_n(int(x_np.shape[0]), self.xg)
        self.mesh, self.axis_name = mesh, axis_name
        self.group = mesh.get_group(axis_name)
        self.rank = axis_index(mesh, axis_name)
        self.n_real, self.n_pad = int(x_np.shape[0]), int(xp.shape[0])
        self.mask = torch.as_tensor(mask[rows], dtype=dtype, device=device)
        self._x_real_np = xp[rows][mask[rows] > 0]
        with torch.no_grad():
            self._yy = psum(torch.dot(self.y.double(), self.y.double()), self.group)
        if solver == "lattice":
            # diag(ŴᵀŴ)'s mean over the real rows of every rank: one psum.
            st = self._real_stream
            local = torch.as_tensor(np.sum(st.w_u.astype(np.float64) ** 2), dtype=torch.float64, device=device)
            self._cbar = float(psum(local, self.group)) / self.M

    # -- this rank's rows ------------------------------------------------------

    @functools.cached_property
    def _real_iw(self):
        """Interpolation weights of this rank's real rows (no pad rows)."""
        return interp_weights(self._x_real_np, [g.reshape(-1).cpu().numpy() for g in self.xg])

    @functools.cached_property
    def _real_stream(self):
        return build_corner_stream(self._real_iw)

    @_timed_plan
    def _wtw_stencil(self):
        """``ŴᵀŴ`` of this rank's real rows as ≤3^d offset tables (K5 on the
        card); None when disabled or over the memory gate."""
        if not self._use_wtw_stencil:
            return None
        return build_wtw_stencil(self._real_iw, stream=self._real_stream, dtype=self.dtype, device=self.device)

    def _generator(self, step: Optional[int] = None) -> torch.Generator:
        """The lattice dual's probes: the single-device model's generator
        (replicated probes).  The data solver's: this rank's own, from
        ``(seed, 7, rank)`` (and ``1000 + step`` in a training step)."""
        if self.solver == "lattice":
            return super()._generator(step)
        key = [self.seed, 7, self.rank] + ([1000 + int(step)] if step is not None else [])
        seed = int(np.random.SeedSequence(key).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _precond_rank(self) -> int:
        r = self._opts["precond_rank"]
        return 0 if r <= 0 else min(r, self.M, self.n_real)

    # -- the sharded operators ---------------------------------------------------

    def _wt_masked(self, v_bm):
        """``Ŵᵀ v`` of this rank's rows ``(B, n_loc)`` summed over the ranks:
        ``(B, M)``, replicated (K4 per rank, one psum)."""
        return psum(self._rmatvec_bm(v_bm * self.mask[None, :]), self.group)

    def _matvec_bm(self, factors, sigma2, precision=None):
        """This rank's rows of ``Â = mask∘(W K Wᵀ)∘mask + σ²I``:
        ``(B, n_loc) → (B, n_loc)`` with one ``(B, M)`` psum."""
        precision = "highest" if precision is None else precision
        mk, group = self.mask[None, :], self.group
        sigma2_r = replicate(sigma2, group)

        def mv(v):
            B = int(v.shape[0])
            u = self._wt_masked(v)
            eyeB = batch_identity(B, dtype=v.dtype, device=v.device)
            u = kron_matvec_fast((eyeB, *factors), u.reshape(-1), precision=precision).reshape(B, -1)
            return self._w_bm(replicate(u, group)) * mk + sigma2_r * v

        return mv

    def _precond_spectral(self, factors, r):
        Qs, lams = _kron_eigh_canonical(factors)
        log_lam, idx = top_p_kron_eigs(lams, r, tie_quantum=TIE_QUANTUM.get(lams[0].dtype))
        U0 = None
        for d_, Qd in enumerate(Qs):
            m_d = Qd.shape[0]
            i0 = self.iw.idx[d_]
            i1 = torch.clamp(i0 + 1, max=m_d - 1)
            w2 = self.iw.w[d_]
            col = (w2[:, 0:1] * Qd[i0, :] + w2[:, 1:2] * Qd[i1, :])[:, idx[:, d_]]
            U0 = col if U0 is None else U0 * col
        return _sharded_spectral_factor(U0 * self.mask[:, None], torch.exp(log_lam), self.group)

    def _build_precond(self, factors, sigma2):
        r = self._precond_rank()
        if r <= 0:
            return None
        U, lam = self._precond_spectral(factors, r)
        return _sharded_lowrank_ops(U, lam, sigma2, self.n_pad, self.group)

    def _lattice_cbar(self) -> float:
        return self._cbar

    def _wtw_bm_op(self):
        """``ŴᵀŴ`` summed over the ranks: this rank's stencil (K5), or
        ``Wᵀ(mask∘W u)`` through its plan, then one psum.  The replicated
        input enters the rank's rows through ``replicate``."""
        group, mk = self.group, self.mask[None, :]
        if self._wtw_op is not None:
            local = self._wtw_op
        else:
            def local(u):
                return self._rmatvec_bm(self._w_bm(u) * mk)
        return lambda u: psum(local(replicate(u, group)), group)

    def _lattice_terms(self, factors, sigma2):
        Qs, wjs, ld_MK = self._lattice_spectra(factors, sigma2)
        to_dual, _, white = self._make_lattice_ops(Qs, wjs)
        return white, to_dual(self._wt_masked(self.y[None, :])), ld_MK

    # -- solves ----------------------------------------------------------------------

    def _solve_bm(self, factors, sigma2, rhs_bm, pre=None):
        """This rank's rows of ``Â⁻¹ rhs`` (the data solver, whitened by the
        deflation), the CG reducing over the group."""
        o = self._opts
        if pre is None:
            pre = self._build_precond(factors, sigma2)
        mv = self._matvec_bm(factors, sigma2)
        _w = pre[1] if pre is not None else (lambda v: v)
        if o["cg_precision"] == "mixed":
            mv_fast = self._matvec_bm(factors, sigma2, precision="default")
            solw, self.cg_info = cg_solve_refined(
                lambda vv: _w(mv_fast(_w(vv))), lambda vv: _w(mv(_w(vv))), _w(rhs_bm),
                tol=max(o["cg_tol"], 1e-7), inner_iters=50, max_restarts=max(1, o["cg_iters"] // 50),
                layout="bm", return_info=True, implicit_diff=False, group=self.group,
            )
        else:
            solw, self.cg_info = cg_solve(
                lambda vv: _w(mv(_w(vv))), _w(rhs_bm), tol=o["cg_tol"], max_iters=o["cg_iters"],
                layout="bm", return_info=True, implicit_diff=False, group=self.group,
            )
        return _w(solw)

    # -- NLML ------------------------------------------------------------------------

    def _data_objective(self, mv, sol, z, ld):
        alpha = sol[0]
        quad = psum(2.0 * torch.dot(self.y, alpha) - torch.dot(alpha, mv(alpha[None, :])[0]), self.group)
        ld = self._surrogate(ld, lambda: psum(torch.sum(sol[1:] * mv(z)), self.group) / z.shape[0])
        return 0.5 * (quad + ld + self.n_real * math.log(2.0 * math.pi))

    def _lattice_objective(self, sigma2, white, vt, ld_MK, sol, z, ld_white):
        gam = sol[0]
        quad = _dual_quad(self._yy, vt[0], gam, white, sigma2)
        ld_white = self._surrogate(ld_white, lambda: torch.sum(sol[1:] * white(z)) / z.shape[0])
        ld = (self.n_real - self.M) * self.log_noise + ld_MK + ld_white
        return 0.5 * (quad + ld + self.n_real * math.log(2.0 * math.pi))

    def _pad_logdet(self):
        """``−(n_pad − n)·log σ²``: the pad rows' σ² block, out of the
        padded operator's log-det."""
        return -(self.n_pad - self.n_real) * self.log_noise.detach()

    def _loss(self) -> torch.Tensor:
        """Sharded NLML with the BBMM surrogate gradient (JAX
        ``parallel/ski.py:662-755``): this rank's rows of the masked probes,
        the whitened CG and SLQ reducing over the group."""
        if self.solver == "lattice":
            return self._loss_lattice()
        o = self._opts
        sigma2 = torch.exp(self.log_noise)
        factors = self._factors()
        mv = self._matvec_bm(factors, sigma2)
        gen = self._generator()
        z = _lz.rademacher((o["num_probes"], self.n), dtype=self.dtype, device=self.device,
                           generator=gen) * self.mask[None, :]
        with torch.no_grad():
            pre = self._build_precond(factors, sigma2)
            sol = self._solve_bm(factors, sigma2, torch.cat([self.y[None, :], z], dim=0), pre=pre)
            if pre is not None:
                M_inv_sqrt, ld_off = pre[1], pre[2]
                slq_mv = lambda vv: M_inv_sqrt(mv(M_inv_sqrt(vv)))  # noqa: E731
            else:
                slq_mv, ld_off = mv, 0.0
            ld = ld_off + _lz.slq_logdet(
                slq_mv, self.n, generator=gen, num_probes=o["num_probes"], lanczos_iters=o["lanczos_iters"],
                dtype=self.dtype, device=self.device, layout="bm", group=self.group,
            ) + self._pad_logdet()
        return self._data_objective(mv, sol, z, ld)

    # -- the host drivers ----------------------------------------------------------------

    def _step_solves(self, generator, R: int, segment_iters: int):
        """One training step's solves (see the single-device model): the lattice
        dual's replicated, the data solver's on this rank's rows with masked
        probes, reducing over the group."""
        o = self._opts
        lattice = self.solver == "lattice"
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            factors = self._factors()
            z = _lz.rademacher((R, self.M if lattice else self.n), dtype=self.dtype, device=self.device,
                               generator=generator)
            unwhiten, group = None, None
            if lattice:
                Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
                to_dual, _, op = self._make_lattice_ops(Qs, wjs)
                rhs = torch.cat([to_dual(self._wt_masked(self.y[None, :])), z], dim=0)
            else:
                z = z * self.mask[None, :]
                op, unwhiten, _ = self._data_op(factors, sigma2)
                rhs = torch.cat([self.y[None, :], z], dim=0)
                if unwhiten is not None:
                    rhs = unwhiten(rhs)
                group = self.group
            x, iters = cg_segments(op, rhs, tol=o["cg_tol"], max_iters=o["cg_iters"],
                                   segment_iters=int(segment_iters), group=group)
            sol = unwhiten(x) if unwhiten is not None else x
        return sol, z, iters

    def log_likelihood_segmented(self, *, cg_segment_iters: int = 60, probe_chunk: int = 8,
                                 fuse_probes: bool = True, verbose: bool = False) -> float:
        """The single-device model's fused CG + SLQ host driver, sharded: the
        lattice dual's replicated, the data solver's on this rank's rows
        (``fused_cg_slq(group=)``).  Value only; the same on every rank."""
        if self.solver == "lattice":
            return super().log_likelihood_segmented(cg_segment_iters=cg_segment_iters, probe_chunk=probe_chunk,
                                                    fuse_probes=fuse_probes, verbose=verbose)
        o = self._opts
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            factors = self._factors()
            op, unwhiten, ld_off = self._data_op(factors, sigma2)
            rhs = self.y[None, :] if unwhiten is None else unwhiten(self.y[None, :])
            x, ld_white, iters = fused_cg_slq(
                op, rhs, generator=self._generator(), num_probes=o["num_probes"],
                lanczos_iters=o["lanczos_iters"], probe_chunk=probe_chunk, cg_tol=o["cg_tol"],
                cg_iters=o["cg_iters"], cg_segment_iters=cg_segment_iters, fuse_probes=fuse_probes,
                verbose=verbose, group=self.group,
            )
            self.cg_iterations = iters
            alpha = x if unwhiten is None else unwhiten(x)
            nlml = self._data_objective(self._matvec_bm(factors, sigma2), alpha, None,
                                        ld_off + ld_white + self._pad_logdet())
        return -float(nlml)

    # -- prediction ----------------------------------------------------------------------

    def _predict_prep(self, factors, sigma2, variance: str, compute_var: bool, var_rank: int) -> dict:
        o = self._opts
        prep = {"factors": factors, "sigma2": sigma2, "S": None, "Tchol": None}
        if self.solver == "lattice":
            Qs, wjs, _ = self._lattice_spectra(factors, sigma2)
            to_dual, from_dual, white = self._make_lattice_ops(Qs, wjs)
            prep["ops"] = (to_dual, from_dual, white)
            vt = to_dual(self._wt_masked(self.y[None, :]))
            prep["Kw_alpha"] = from_dual(cg_solve(white, vt, tol=o["cg_tol"], max_iters=o["cg_iters"],
                                                  layout="bm"))[0]
            return prep
        prep["pre"] = pre = self._build_precond(factors, sigma2)
        alpha = self._solve_bm(factors, sigma2, self.y[None, :], pre=pre)
        prep["Kw_alpha"] = kron_matvec_fast(factors, self._wt_masked(alpha)[0], precision="highest")
        return prep

    def _predict_chunk(self, prep: dict, variance: str, compute_var: bool, xc):
        if self.solver == "lattice" or not compute_var:
            return super()._predict_chunk(prep, variance, compute_var, xc)
        from gp_grief_tpu_torch.ops.interp import interp_matvec, interp_matvec_bm_fast, interp_rmatvec_bm

        factors = prep["factors"]
        iw_c = interp_weights(xc, self.xg)
        mean = interp_matvec(iw_c, prep["Kw_alpha"])
        c = int(xc.shape[0])
        eyeC = batch_identity(c, dtype=self.dtype, device=self.device)
        Wst_bm = interp_rmatvec_bm(iw_c, eyeC)
        u = kron_matvec_fast((eyeC, *factors), Wst_bm.reshape(-1), precision="highest")
        C_bm = interp_matvec_bm_fast(self._plan, u.reshape(c, -1)) * self.mask[None, :]  # (c, n_loc)
        Sol = self._solve_bm(factors, prep["sigma2"], C_bm, pre=prep["pre"])
        var = self._prior_diag(factors, iw_c) - psum(torch.sum(C_bm * Sol, dim=1), self.group)
        return mean, torch.clamp_min(var, 0.0)

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False, chunk: int = 0,
                variance: str = "exact", **kw):
        """Predictive mean (and exact variance) at ``x_new``, replicated: every
        rank calls it with the same points and gets the same tensors.  LOVE
        (``variance="lanczos"``) is not sharded, as in the JAX package."""
        if variance != "exact":
            raise NotImplementedError("ShardedGPSKIRegression.predict: only variance='exact' is sharded")
        if chunk <= 0:
            # The single-device rule, from the whole data set's size.
            n_star = int(len(x_new))
            chunk = int(max(1, min(n_star, max(8, (1 << 26) // max(self.n_pad + self.M, 1)))))
        return super().predict(x_new, compute_var=compute_var, include_noise=include_noise, chunk=chunk,
                               variance="exact", **kw)

