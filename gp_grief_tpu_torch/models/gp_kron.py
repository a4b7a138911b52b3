"""Exact GP regression for data on a full Cartesian grid (Kronecker algebra).

Counterpart of ``gp_grief_tpu.models.gp_kron.GPKroneckerRegression``.  With
training inputs on a product grid, ``K = ⊗_d K_d`` and

    log|K + σ²I| = Σ_j log(λ⊗_j + σ²),     (λ⊗ = flattened ⊗_d λ_d)
    (K + σ²I)⁻¹ y = Q (Qᵀy / (λ⊗ + σ²))    (Q = ⊗_d Q_d by Kronecker matvecs)

so the exact NLML on ``M = Π m_d`` points costs ``O(Σ m_d³)`` for the eigh
plus ``O(M · Σ m_d)`` per matvec.  ``solver="cg"`` computes the quadratic
term iteratively instead, through ``kron_matvec_fast`` and so through
kernels K2/K3 on the card: exact CG, mixed-precision refinement
(``cg_precision="mixed"``/``"mixed16"``), and an optional rank-p Kronecker
deflation preconditioner (``precond_rank``).  CG training differentiates
through the solve by its implicit gradient (``ops.cg``).

With ``mesh=`` (a ``DeviceMesh``; the JAX package's model-parallel matvec)
the CG NLML runs sharded over the mesh axis ``model_axis``: each rank holds
its block of the lattice's leading axis, every matvec is
``parallel.sharded.kron_matvec_sharded`` (one reduce-scatter), the
deflation's two Kronecker matvecs are sharded the same way, and the solver's
``group=`` all-reduces its dot products.  The eigendecompositions and the
log-det stay replicated; ``predict`` and ``log_likelihood_segmented`` run
the local matvec, as in the JAX package.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from gp_grief_tpu_torch.kernels.base import inverse_positive
from gp_grief_tpu_torch.kernels.diag import cov_diag
from gp_grief_tpu_torch.kernels.grid import cov_grid, cross_cov_grid
from gp_grief_tpu_torch.kernels.stationary import Stationary
from gp_grief_tpu_torch.models.base import BaseModel, resolve_device
from gp_grief_tpu_torch.ops.collectives import axis_index, axis_size, psum, replicate
from gp_grief_tpu_torch.ops.cg import CGInfo, cg_segments, cg_solve, cg_solve_refined
from gp_grief_tpu_torch.ops.khatri_rao import kr_expand, kr_matvec
from gp_grief_tpu_torch.ops.kron import kron_eigh, kron_matvec, kron_solve_schur, lam_kron
from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast
from gp_grief_tpu_torch.ops.precond import kron_deflation_sqrt_ops
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs

__all__ = ["GPKroneckerRegression"]


def _clamp_psd(lams):
    """Clamp per-dimension eigenvalues at their round-off floor
    ``10·eps·λmax``: ``eigh`` returns small negatives for PSD Grams, which the
    other dimensions' λmax would amplify in the Kronecker product until
    ``log(λ⊗ + σ²)`` turns NaN."""
    out = []
    for lam in lams:
        floor = 10.0 * torch.finfo(lam.dtype).eps * torch.max(lam)
        out.append(torch.maximum(lam, floor))
    return tuple(out)


class GPKroneckerRegression(BaseModel):
    """Exact GP on a Cartesian grid: ``GPKroneckerRegression(xg, y, kern_list)``.

    ``xg``: per-dimension grid points ``(m_d, s_d)`` (``s_d > 1`` groups input
    columns per grid dimension, ``sub_dim``); ``y``: responses on the full
    lattice, C-order flattened, ``(Π m_d,)``.  ``dims[d]`` names the test
    input columns of grid dimension ``d`` (default: consecutive blocks of
    width ``s_d``).

    ``dtype`` defaults to ``y``'s floating type (float32 stays float32,
    anything else becomes float64); ``device`` to ``y``'s device for a tensor
    ``y``, else the card (``device="cpu"`` for the CPU; without a CUDA device
    and without ``device`` the constructor raises).

    ``optimize`` trains either solver; under ``solver="cg"`` the gradient of
    the quadratic term is the CG implicit gradient (``ops.cg``).

    ``mesh``/``model_axis``: the sharded CG NLML (module docstring); needs
    ``solver="cg"``, an axis of that name, and a leading grid size that
    divides by the axis size.
    """

    def __init__(
        self,
        xg: Sequence,
        y,
        kern_list: Union[Stationary, Sequence[Stationary]],
        *,
        noise_var: float = 1.0,
        dim_noise_var: float = 0.0,
        solver: str = "schur",
        cg_tol: float = 1e-10,
        cg_iters: int = 1000,
        precond_rank: int = 0,
        cg_precision: str = "exact",
        cg_whiten="auto",
        mesh=None,
        model_axis: str = "model",
        dims=None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if dtype is None:
            if isinstance(y, torch.Tensor) and y.is_floating_point():
                dtype = y.dtype
            else:
                dtype = torch.float32 if np.asarray(y).dtype == np.float32 else torch.float64
        device = resolve_device(y, device)

        def _t(a):
            if isinstance(a, torch.Tensor):
                return a.to(dtype=dtype, device=device)
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.xg = tuple(_t(g) for g in xg)
        sub = [1 if g.ndim == 1 else int(g.shape[1]) for g in self.xg]
        if dims is None:
            dims, off = [], 0
            for s in sub:
                dims.append(tuple(range(off, off + s)))
                off += s
        else:
            dims = [tuple(int(c) for c in cols) for cols in dims]
            if len(dims) != len(self.xg) or any(len(cols) != s for cols, s in zip(dims, sub)):
                raise ValueError(
                    f"dims must give one column list per grid dimension with widths {sub}; "
                    f"got {[len(c) for c in dims]}"
                )
            flat = [c for cols in dims for c in cols]
            n_cols = sum(sub)
            if len(set(flat)) != len(flat) or any(c < 0 or c >= n_cols for c in flat):
                raise ValueError(f"dims column indices must be distinct and in [0, {n_cols}); got {dims}")
        self.dims = tuple(dims)
        self._n_cols = sum(sub)
        y = _t(y).reshape(-1)
        m = math.prod(int(g.shape[0]) for g in self.xg)
        if y.shape[0] != m:
            raise ValueError(f"y must have one response per grid point: grid has {m} points, y has {y.shape[0]}")
        self.y, self.m = y, m
        self.dim_noise_var = float(dim_noise_var)
        if solver not in ("schur", "cg"):
            raise ValueError("solver must be 'schur' or 'cg'")
        self.solver = solver
        self.cg_tol, self.cg_iters = cg_tol, cg_iters
        # CG option: deflate the top-`precond_rank` Kronecker eigenpairs.
        self.precond_rank = int(precond_rank)
        # "exact": every CG matvec at full precision.  "mixed": iterative
        # refinement, the inner CG on the bf16-operand matvec (K2 on the card)
        # with exact residual refreshes.  "mixed16": also the inner CG state
        # in bf16.
        if cg_precision not in ("exact", "mixed", "mixed16"):
            raise ValueError("cg_precision must be 'exact', 'mixed' or 'mixed16'")
        self.cg_precision = cg_precision
        # Whitened CG (M^{-1/2} A M^{-1/2}) is required when σ² < ε_f32·λmax,
        # where data-space PCG's curvature is lost to rounding; "auto" decides
        # from the construction noise.
        if cg_whiten == "auto":
            cg_whiten = float(noise_var) < 1e-4
        self.cg_whiten = bool(cg_whiten)
        # Model parallelism: the CG NLML's matvecs sharded over `model_axis`.
        self.mesh = mesh
        self.model_axis = str(model_axis)
        if mesh is not None:
            if solver != "cg":
                raise ValueError(
                    "mesh= (model-parallel matvec) requires solver='cg' — the schur path has no large matvec to shard"
                )
            names = tuple(mesh.mesh_dim_names or ())
            if model_axis not in names:
                raise ValueError(f"mesh has no axis {model_axis!r}: {dict(zip(names, mesh.shape))}")
            km = int(mesh.shape[names.index(model_axis)])
            m1 = int(self.xg[0].shape[0])
            if m1 % km:
                raise ValueError(
                    f"leading grid dimension ({m1} points) must be divisible by the {model_axis!r} mesh axis "
                    f"size ({km} devices) — pad the first grid dimension or reorder dimensions so a divisible "
                    "one is first"
                )
        # CGInfo of the last CG log-likelihood evaluation (None before one).
        self.cg_info: Optional[CGInfo] = None
        kerns = list(kern_list) if isinstance(kern_list, (list, tuple)) else [kern_list] * len(self.xg)
        # One copy per dimension: a shared kernel becomes d independent
        # parameter sets, as the JAX pytree's leaves are.
        self.kernels = nn.ModuleList([copy.deepcopy(k).to(dtype=dtype, device=device) for k in kerns])
        self.log_noise = nn.Parameter(inverse_positive(noise_var, dtype=dtype, device=device))
        if device.type == "cuda":
            # The JAX reference's dots are full float32; TF32 keeps ~3 digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _factors(self):
        return cov_grid(self.kernels, self.xg, dim_noise_var=self.dim_noise_var)

    @staticmethod
    def _eig(factors):
        Qs, lams = kron_eigh(factors)
        return Qs, _clamp_psd(lams)

    def _loss(self) -> torch.Tensor:
        sigma2 = torch.exp(self.log_noise)
        factors = self._factors()
        Qs, lams = self._eig(factors)
        lam = lam_kron(lams)
        if self.solver == "schur":
            z = kron_matvec(tuple(Q.T for Q in Qs), self.y)
            quad = torch.sum(z * z / (lam + sigma2))
        else:
            quad = self._cg_quad(factors, Qs, lams, sigma2)
        logdet = torch.sum(torch.log(lam + sigma2))
        return 0.5 * (quad + logdet + self.m * math.log(2.0 * math.pi))

    def _cg_quad(self, factors, Qs, lams, sigma2) -> torch.Tensor:
        """``yᵀ(K + σ²I)⁻¹y`` by CG.  Differentiable through the solve's
        implicit gradient (one more solve of the same kind in the backward)
        and through the whitener ``M^{-1/2}``, as in the JAX package; the
        data-space preconditioner hook carries no gradient."""
        if self.mesh is not None:
            return self._cg_quad_sharded(factors, Qs, lams, sigma2)
        M_inv = M_inv_sqrt = None
        if self.precond_rank > 0:
            _, idx = top_p_kron_eigs(lams, self.precond_rank)
            M_inv, M_inv_sqrt, _ = kron_deflation_sqrt_ops(Qs, lams, idx, sigma2)
        factors = tuple(K.contiguous() for K in factors)

        def kmv(u, precision):
            return kron_matvec_fast(factors, u, precision=precision)

        return self._cg_quad_solve(kmv, M_inv, M_inv_sqrt, sigma2, self.y, None)

    def _cg_quad_sharded(self, factors, Qs, lams, sigma2) -> torch.Tensor:
        """:meth:`_cg_quad` with the lattice's leading axis sharded over
        ``model_axis``: this rank's rows of ``y``, the sharded matvec and
        deflation, and the solver reducing over the axis' group."""
        from gp_grief_tpu_torch.parallel.sharded import kron_matvec_sharded

        mesh, axis = self.mesh, self.model_axis
        group = mesh.get_group(axis)
        n_loc = self.m // axis_size(mesh, axis)
        j = axis_index(mesh, axis)
        y_loc = self.y[j * n_loc : (j + 1) * n_loc]
        kmv_sharded = functools.partial(kron_matvec_sharded, mesh=mesh, axis_name=axis)
        M_inv = M_inv_sqrt = None
        if self.precond_rank > 0:
            _, idx = top_p_kron_eigs(lams, self.precond_rank)
            # The eigenvalues and σ² enter this rank's rows: replicated,
            # their gradient summed over the ranks once.
            *lams_r, sigma2_r = replicate((*lams, sigma2), group)
            M_inv, M_inv_sqrt, _ = kron_deflation_sqrt_ops(Qs, lams_r, idx, sigma2_r, kmv=kmv_sharded,
                                                           rows=(j * n_loc, n_loc))

        def kmv(u, precision):
            return kmv_sharded(factors, u, precision=precision)

        quad_loc = self._cg_quad_solve(kmv, M_inv, M_inv_sqrt, replicate(sigma2, group), y_loc, group)
        return psum(quad_loc, group)

    def _cg_quad_solve(self, kmv, M_inv, M_inv_sqrt, sigma2, y, group) -> torch.Tensor:
        """``yᵀ(K + σ²I)⁻¹y`` (this rank's part of it with a ``group``) by CG
        on ``kmv(u, precision) = (⊗K_d)u``."""
        whiten = self.cg_whiten and M_inv_sqrt is not None
        _w = M_inv_sqrt if whiten else (lambda v: v)
        M_inv_hook = None if whiten else M_inv

        def mv_exact_w(v):
            u = _w(v)
            return _w(kmv(u, "highest") + sigma2 * u)

        def mv_fast_w(v):
            u = _w(v)
            return _w(kmv(u, "default") + sigma2 * u)

        # Batch-major (1, m) state; every operator runs on the flat (m,) vector.
        def _bm(op):
            return lambda vv: op(vv[0])[None, :]

        rhs_w = _w(y)
        precond = None if M_inv_hook is None else _bm(M_inv_hook)
        # Deflation and mixed refinement do not compose on this operator: the
        # bf16 matvec's absolute error (∝ λmax) swamps the deflated subspace
        # (benchmarks/RESULTS_r5.md §12), so mixed precision applies only
        # unpreconditioned, as in the JAX package.
        if self.cg_precision in ("mixed", "mixed16") and self.precond_rank == 0:
            alpha_w, self.cg_info = cg_solve_refined(
                _bm(mv_fast_w), _bm(mv_exact_w), rhs_w[None, :],
                tol=max(self.cg_tol, 1e-7), inner_iters=50, max_restarts=max(1, self.cg_iters // 50),
                M_inv=precond, state_dtype=torch.bfloat16 if self.cg_precision == "mixed16" else None,
                layout="bm", return_info=True, group=group,
            )
        else:
            alpha_w, self.cg_info = cg_solve(
                _bm(mv_exact_w), rhs_w[None, :], tol=self.cg_tol, max_iters=self.cg_iters,
                M_inv=precond, layout="bm", return_info=True, group=group,
            )
        # quad = yᵀA⁻¹y = (M⁻½y)ᵀ (M⁻½AM⁻½)⁻¹ (M⁻½y) = rhs_w·alpha_w.
        return torch.dot(rhs_w, alpha_w[0])

    def log_likelihood_segmented(self, *, cg_segment_iters: int = 60, verbose: bool = False) -> float:
        """Value-only log marginal likelihood with the quadratic term solved by
        CG in host-driven segments of ``cg_segment_iters`` iterations
        (:func:`ops.cg.cg_segments`, one residual read per segment).

        The log-det stays the closed form ``Σ log(λ⊗ + σ²)`` on the clamped
        eigenvalues; the solve runs on the exact operator
        (``kron_matvec_fast(..., precision="highest")``) whatever
        ``cg_precision`` says, as in the JAX package, whitened by the
        Kronecker deflation when ``cg_whiten`` and ``precond_rank > 0``, else
        preconditioned by it in data space.  It stops at ``max(cg_tol,
        20·eps)`` relative, after ``ceil(cg_iters / cg_segment_iters)``
        segments, or when a segment stalls (the port's stagnation stop).
        ``cg_iterations`` holds the iterations run; ``verbose`` prints one
        line per segment."""
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            factors = self._factors()
            Qs, lams = self._eig(factors)
            logdet = torch.sum(torch.log(lam_kron(lams) + sigma2))
            factors = tuple(K.contiguous() for K in factors)
            _w, M_inv = (lambda v: v), None
            if self.precond_rank > 0:
                _, idx = top_p_kron_eigs(lams, self.precond_rank)
                M_inv_flat, M_inv_sqrt, _ = kron_deflation_sqrt_ops(Qs, lams, idx, sigma2)
                if self.cg_whiten:
                    _w = M_inv_sqrt
                else:
                    def M_inv(r):
                        return M_inv_flat(r[0])[None]

            # Batch-major (1, m) state; the operators run on the flat (m,) vector.
            def op(v):
                u = _w(v[0])
                return _w(kron_matvec_fast(factors, u, precision="highest") + sigma2 * u)[None]

            rhs = _w(self.y)[None, :]
            x, self.cg_iterations = cg_segments(
                op, rhs, tol=self.cg_tol, max_iters=self.cg_iters, segment_iters=int(cg_segment_iters), M_inv=M_inv,
                verbose=verbose,
            )
            # quad = yᵀA⁻¹y = (M⁻½y)ᵀ(M⁻½AM⁻½)⁻¹(M⁻½y): rhs·x in both branches.
            quad = float(torch.dot(rhs[0], x[0]))
        return -0.5 * (quad + float(logdet) + self.m * math.log(2.0 * math.pi))

    def predict(self, x_new, compute_var: bool = True, include_noise: bool = False, chunk: int = 0):
        """Posterior mean (and variance) at scattered points, off the grid.

        mean = K_*U α (one Khatri-Rao matvec per chunk); the variance solves
        against the ``(c, m)`` cross-covariance rows of one test chunk at a
        time, with the chunk folded into the Kronecker structure as a leading
        identity factor, so only ``m × chunk`` values are live.  ``chunk=0``
        sizes the chunk from ``m`` (~2²⁷ values, at least 16).  Returns
        tensors on the model's device.
        """
        x_new = x_new.to(dtype=self.y.dtype, device=self.y.device) if isinstance(x_new, torch.Tensor) else \
            torch.as_tensor(np.asarray(x_new), dtype=self.y.dtype, device=self.y.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        if int(x_new.shape[1]) != self._n_cols:
            raise ValueError(
                f"test points must have {self._n_cols} columns (the grid's total sub_dim width); "
                f"got {int(x_new.shape[1])}"
            )
        n_star = int(x_new.shape[0])
        if n_star == 0:
            empty = torch.zeros((0,), dtype=self.y.dtype, device=self.y.device)
            return empty if not compute_var else (empty, empty.clone())
        if chunk <= 0:
            chunk = int(max(1, min(n_star, max(16, (1 << 27) // max(self.m, 1)))))
        chunk = min(chunk, n_star)
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            Qs, lams = self._eig(self._factors())
            alpha = kron_solve_schur(Qs, lams, self.y, sigma2)
            means, vars_ = [], []
            for i in range(0, n_star, chunk):
                xc = x_new[i : i + chunk]
                Kx = cross_cov_grid(self.kernels, xc, self.xg, dims=self.dims)  # (c, m_d) per dim
                means.append(kr_matvec(list(Kx), alpha))
                if compute_var:
                    c = int(xc.shape[0])
                    KUx = kr_expand(Kx)  # (c, m): row i = ⊗_d Kx_d[i, :]
                    # I_c ⊗ (⊗K_d) has eigensystem (I_c ⊗ Q, 1_c ⊗ λ): the
                    # Schur solve runs unchanged on the (c·m,) flat vector.
                    S = kron_solve_schur(
                        (torch.eye(c, dtype=KUx.dtype, device=KUx.device), *Qs),
                        (torch.ones((c,), dtype=KUx.dtype, device=KUx.device), *lams),
                        KUx.reshape(-1), sigma2,
                    ).reshape(c, -1)
                    var = cov_diag(list(self.kernels), xc, dims=self.dims) - torch.sum(KUx * S, dim=1)
                    vars_.append(torch.clamp_min(var, 0.0))
            mean = torch.cat(means)
            if not compute_var:
                return mean
            var = torch.cat(vars_)
            if include_noise:
                var = var + sigma2
        return mean, var
