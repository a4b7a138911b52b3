"""Exact GP regression: the parity oracle, and the large-n exact GP.

Counterpart of ``gp_grief_tpu.models.gp_regression``: a zero-mean GP with
Gaussian noise.  ``solver="cholesky"`` factorizes the ``(n, n)`` Gram: the
NLML by a Cholesky factor, the predictive mean and variance by triangular
solves.  ``solver="iterative"`` replaces the factor by CG solves (the
quadratic term, predictions) and SLQ (the log-det), with BBMM surrogates
carrying the gradient, on the dense Gram (``matvec_chunk = 0``) or on the
matrix-free operator of :func:`make_gram_matvec` (``matvec_chunk > 0``),
which never holds an ``(n, n)`` buffer, so n is bounded by compute (n = 500k
fits one card).  ``precond_rank > 0`` whitens CG and SLQ with a partial
pivoted Cholesky factor (``ops.precond.pivoted_cholesky_matfree``).  On the
card the solver's applies of one stationary kernel run on kernel K9
(``ops.cuda.gram``), and their differentiated applies on K9 with kernel
K10's hyperparameter cotangents in the backward; every other apply, and
every apply on the CPU, rebuilds ``(chunk, n)`` Gram slabs by PyTorch ops
and contracts them.
"""

from __future__ import annotations

import copy
import math
import time
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gp_grief_tpu_torch.kernels.base import inverse_positive
from gp_grief_tpu_torch.kernels.diag import cov_diag
from gp_grief_tpu_torch.kernels.grid import product_cov
from gp_grief_tpu_torch.kernels.stationary import Stationary, _from_r2, _use_broadcast_dist
from gp_grief_tpu_torch.models.base import BaseModel, check_xy, resolve_device
from gp_grief_tpu_torch.models.gp_grief import _resolve_dtype, _to_tensor
from gp_grief_tpu_torch.ops import lanczos as _lz
from gp_grief_tpu_torch.ops.cuda.gram import GramApply, fused_route, gram_apply
from gp_grief_tpu_torch.ops.cg import cg_segments, cg_solve, cg_solve_refined
from gp_grief_tpu_torch.ops.fused import fused_cg_slq
from gp_grief_tpu_torch.ops.precond import (
    gram64,
    lowrank_spectral_factor,
    lowrank_sqrt_ops,
    pivoted_cholesky,
    pivoted_cholesky_matfree,
    whitening_logdet,
)
from gp_grief_tpu_torch.ops.solve import cholesky, logdet_from_chol
from gp_grief_tpu_torch.optimize import FitResult
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["GPRegression", "gp_nlml", "gp_nlml_iterative", "make_gram_matvec"]

_gram_span = _prof.site("gp_grief.gram", "B", "n", "blocks", "route")
_slab_span = _prof.site("gp_grief.gram.slab")
_contract_span = _prof.site("gp_grief.gram.contract")
_step_span = _prof.site("gp_grief.model.step", "step", entry=True)
_step_solve_span = _prof.site("gp_grief.model.step.solve")
_step_grad_span = _prof.site("gp_grief.model.step.grad")

KernelLike = Union[Stationary, Sequence[Stationary]]

_ITER_KEYS = ("num_probes", "lanczos_iters", "cg_tol", "cg_iters", "precond_rank", "matvec_chunk", "mixed16")


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


def _kernel_params(kernels) -> list:
    return [p for k in (kernels if _is_list(kernels) else [kernels]) for p in k.parameters()]


def _solver_slab(kernels: KernelLike, xblk: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``cov(kernels, xblk, x)`` with no graph, bit for bit.  For one
    stationary kernel whose distances take the matmul form (``_sq_dist``'s
    second regime) the slab is built by in-place chains, two slab-sized
    tensors and a mask where the out-of-place ops make ~10; each in-place op
    computes the same IEEE operation as the one it replaces.  ``_sq_dist``'s
    clamp at 0 is left out: the snap threshold ``16·eps·scale`` is ≥ 0, so
    the snap zeroes every entry the clamp would."""
    k = kernels
    n, m, d = xblk.shape[0], x.shape[0], x.shape[1]
    if not isinstance(k, Stationary) or _use_broadcast_dist(n, m, d):
        return _cov_any(k, xblk, x)
    ls = torch.broadcast_to(k.lengthscale, (d,))
    xs, zs = xblk / ls, x / ls
    mean = torch.mean(xs, dim=-2, keepdim=True)
    xs, zs = xs - mean, zs - mean
    x2, z2 = torch.sum(xs * xs, dim=-1), torch.sum(zs * zs, dim=-1)
    r2 = (xs @ zs.T).mul_(-2.0)
    scale = x2[:, None] + z2[None, :]
    r2.add_(scale)
    r2.masked_fill_(r2 <= scale.mul_(16.0 * torch.finfo(r2.dtype).eps), 0.0)
    del scale
    if k.kind == "rbf":
        return r2.mul_(-0.5).exp_().mul_(k.variance)
    return _from_r2(k.kind, k.variance, r2)


def _round_bf16(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(torch.bfloat16).to(dtype)


def _contract(vv: torch.Tensor, K: torch.Tensor, fast: bool) -> torch.Tensor:
    """``vv Kᵀ`` in ``K``'s dtype; with ``fast``, of the operands rounded to
    bf16 (their products are exact in float32, so this is a bf16-operand
    product with float32 accumulation and output)."""
    if fast:
        return _round_bf16(vv, K.dtype) @ _round_bf16(K, K.dtype).T
    return vv.to(K.dtype) @ K.T


def make_gram_matvec(kernels: KernelLike, x: torch.Tensor, sigma2, *, chunk: int, precision: str = "highest"):
    """Row-chunked matrix-free ``vv ↦ vv (K + σ²I)`` (``vv``: ``(B, n)``).

    On the slab path ``x`` is zero-padded to whole ``chunk``-row blocks;
    each apply rebuilds the ``(chunk, n)`` slab of every block and contracts
    it at once, so the live set is one slab and the ``(B, n)`` state.  The
    output dtype is that of ``x`` and ``vv`` (not of the hyperparameters).

    Two roles, picked per call by grad mode:

    * the solver operator (grad mode off, or nothing requires grad), the
      hyperparameters read as values: where
      :func:`~gp_grief_tpu_torch.ops.cuda.gram.fused_route` holds (one
      stationary kernel, ``x`` and ``vv`` on the card in float32 or float64,
      ``d ≤ 8``), kernel K9 in one pass with no slab in device memory;
      otherwise each slab built by :func:`_solver_slab` under
      ``torch.no_grad()``.  K9's bits differ from the slab path's, and that
      is its only departure: its distances are direct differences (the slab
      path's take the matmul form past ``_sq_dist``'s broadcast regime), and
      it sums in another order (the variance and ``σ² vv`` applied after
      the sum);
    * the differentiated operator (the BBMM surrogates): where the same
      predicate holds, at ``"highest"``, with ``x`` needing no gradient,
      :class:`~gp_grief_tpu_torch.ops.cuda.gram.GramApply`: K9's forward
      and, in the backward, kernel K10's one pass for the lengthscales' and
      the variance's cotangents (``vv``'s, where it needs one, from one more
      K9 call), ``+ σ² vv`` left to autograd, which gives ``σ²`` its
      cotangent; otherwise each row block under
      ``torch.utils.checkpoint`` (non-reentrant), so autograd keeps each
      block's inputs only and the backward rebuilds the slab.  Neither saves
      an O(n²) buffer.

    Under a profiler each apply is the span ``gp_grief.gram`` (attribute
    ``route``: ``"fused"``, ``"fused_grad"`` or ``"slab"``), each solver
    apply on K9 adds 1 to the counter ``gram_fused_applies``, and each
    backward on K10 is the span ``gp_grief.gram.grad`` and adds 1 to
    ``gram_fused_grads``.

    ``precision``: ``"highest"`` (float32 slab and contraction, TF32 off on
    the card), or ``"default"``, the fast operator of the mixed16 refinement
    pair: the slab and ``vv`` rounded to bf16 and contracted with float32
    products, accumulation and output (the TPU's bf16-operand product).  The
    JAX package's "default" also builds the distances from bf16 products;
    here they stay float32, since bf16's cancellation in ``‖x‖² + ‖z‖² −
    2x·z`` loses every short distance."""
    if precision not in ("highest", "default"):
        raise ValueError("precision must be 'highest' or 'default'")
    fast = precision == "default"
    n, dim = x.shape
    chunk = int(min(chunk, n))
    pad = -(-n // chunk) * chunk - n
    blocks = (torch.cat([x, x.new_zeros((pad, dim))]) if pad else x).split(chunk)
    params = _kernel_params(kernels)
    fused = fused_route(kernels, x.device.type, x.dtype, dim)

    def block(vv, xblk, slab=_cov_any):
        with _slab_span():
            K = slab(kernels, xblk, x)
        with _contract_span():
            return _contract(vv, K, fast)

    def mv(vv: torch.Tensor) -> torch.Tensor:
        sig = torch.as_tensor(sigma2, device=x.device)
        live = torch.is_grad_enabled() and (vv.requires_grad or sig.requires_grad
                                             or any(p.requires_grad for p in params))
        route = "slab"
        if fused and vv.dtype == x.dtype and vv.device == x.device:
            if not live:
                route = "fused"
            elif precision == "highest" and not x.requires_grad:
                route = "fused_grad"
        with _gram_span(int(vv.shape[0]), n, len(blocks), route):
            if route == "fused":
                _prof.count("gram_fused_applies")
                return gram_apply(kernels, x, vv, sig, precision)
            if route == "fused_grad":
                ls = torch.broadcast_to(kernels.lengthscale, (dim,))
                return GramApply.apply(kernels.kind, x, vv, ls, kernels.variance) + sig.to(x.dtype) * vv
            od = torch.promote_types(x.dtype, vv.dtype)
            if live:
                outs = [checkpoint(block, vv, xb, use_reentrant=False, preserve_rng_state=False) for xb in blocks]
            else:
                with torch.no_grad():
                    outs = [block(vv, xb, _solver_slab) for xb in blocks]
            return torch.cat(outs, dim=1)[:, :n].to(od) + sig.to(od) * vv.to(od)

    return mv


def _gram_row_fn(kernels: KernelLike, x: torch.Tensor):
    """``row_fn(i) -> K[i, :]`` for :func:`pivoted_cholesky_matfree` (``i`` a
    0-d index tensor: no host read)."""

    def row(i):
        return _cov_any(kernels, x.index_select(0, i.reshape(1)), x)[0]

    return row


def _whitener(kernels, x, sigma2, rank: int, K: Optional[torch.Tensor] = None, Lpc=None):
    """``(Lpc, M^{-1/2}, log|M|)`` of the rank-``rank`` pivoted-Cholesky
    preconditioner ``M = LLᵀ + σ²I``, built without a graph: from the dense
    Gram ``K`` when given, else from ``rank`` kernel rows; ``Lpc`` reuses a
    factor.  ``log|M|`` is that of the whitening applied
    (:func:`~gp_grief_tpu_torch.ops.precond.whitening_logdet`), in
    ``Lpc``'s dtype."""
    with torch.no_grad():
        if Lpc is None:
            if K is not None:
                Lpc = pivoted_cholesky(K, rank)
            else:
                Lpc = pivoted_cholesky_matfree(_gram_row_fn(kernels, x), cov_diag(kernels, x), rank)
        s2 = torch.as_tensor(sigma2).to(Lpc.dtype)
        U, lam = lowrank_spectral_factor(Lpc)
        _, M_inv_sqrt, _ = lowrank_sqrt_ops(U, lam, s2, layout="bm")
        logdet_M = whitening_logdet(gram64(U), lam, s2, U.shape[0]).to(Lpc.dtype)
    return Lpc, M_inv_sqrt, logdet_M


def _whiten(op, M_inv_sqrt, dtype):
    """``M^{-1/2} op M^{-1/2}``; the input is cast to ``dtype`` first (the
    mixed16 inner CG hands its operator bf16 state)."""
    return lambda vv: M_inv_sqrt(op(M_inv_sqrt(vv.to(dtype))))


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


def _needs_grad(kernels, log_noise) -> bool:
    return torch.is_grad_enabled() and (log_noise.requires_grad
                                        or any(p.requires_grad for p in _kernel_params(kernels)))


def gp_nlml_iterative(
    kernels: KernelLike,
    log_noise: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    generator: Optional[torch.Generator],
    num_probes: int = 32,
    lanczos_iters: int = 64,
    cg_tol: float = 1e-8,
    cg_iters: int = 1000,
    precond_rank: int = 0,
    matvec_chunk: int = 0,
    mixed16: bool = False,
) -> torch.Tensor:
    """Large-n NLML: the CG quadratic form and the SLQ log-det, with BBMM
    gradients (JAX ``gp_regression.py:146-338``).

    ``matvec_chunk > 0`` takes the matrix-free operator
    (:func:`make_gram_matvec`) and builds the preconditioner from kernel rows;
    ``0`` the dense Gram.  ``precond_rank > 0`` whitens: CG and SLQ run on
    ``M^{-1/2} Ã M^{-1/2}`` with ``log|Ã| = log|M| + log|M^{-1/2} Ã M^{-1/2}|``.
    ``mixed16`` (matrix-free only) solves by iterative refinement, the inner
    CG on the bf16 operator with bf16 state.  One batched solve for ``[y,
    z_1..z_R]``; solves, preconditioner and SLQ are values, and the gradient
    comes from the surrogates

        ∂ yᵀÃ⁻¹y  = −αᵀ (∂Ã) α,                       α   = Ã⁻¹y
        ∂ log|Ã|  ≈ (1/R) Σ_r s_rᵀ (∂Ã) z_r,          s_r = Ã⁻¹z_r,

    built only when a gradient is needed.  ``generator`` draws the probes:
    ``z`` first, then SLQ's."""
    n = x.shape[0]
    sigma2 = torch.exp(log_noise)
    dtype = y.dtype
    K = mv_fast = None
    if matvec_chunk > 0:
        mv = make_gram_matvec(kernels, x, sigma2, chunk=matvec_chunk)
        if mixed16:
            mv_fast = make_gram_matvec(kernels, x, sigma2, chunk=matvec_chunk, precision="default")
    else:
        K = _cov_any(kernels, x)

        def mv(vv):
            return vv @ K + sigma2 * vv

    z = _lz.rademacher((num_probes, n), dtype=dtype, device=y.device, generator=generator)
    rhs = torch.cat([y[None, :], z], dim=0)
    with torch.no_grad():
        r = int(min(precond_rank, n))
        if r > 0:
            _, M_inv_sqrt, ld_off = _whitener(kernels, x, sigma2, r, K=None if K is None else K.detach())
            op, unwhiten = _whiten(mv, M_inv_sqrt, dtype), M_inv_sqrt
            op_fast = _whiten(mv_fast, M_inv_sqrt, dtype) if mv_fast is not None else None
        else:
            op, op_fast, unwhiten, ld_off = mv, mv_fast, (lambda v: v), 0.0
        b = unwhiten(rhs)
        if op_fast is not None:
            solw = cg_solve_refined(op_fast, op, b, tol=cg_tol, inner_iters=25, max_restarts=max(1, cg_iters // 25),
                                    layout="bm", state_dtype=torch.bfloat16, implicit_diff=False)
        else:
            solw = cg_solve(op, b, tol=cg_tol, max_iters=cg_iters, layout="bm", implicit_diff=False)
        sol = unwhiten(solw)
        ld_val = ld_off + _lz.slq_logdet(op, n, generator=generator, num_probes=num_probes,
                                         lanczos_iters=lanczos_iters, dtype=dtype, device=y.device, layout="bm")
    alpha, S = sol[0], sol[1:]
    # Quadratic term: value yᵀα, gradient −αᵀ(∂Ã)α.
    quad = 2.0 * torch.dot(y, alpha) - torch.dot(alpha, mv(alpha[None, :])[0])
    ld = ld_val
    if _needs_grad(kernels, log_noise):
        g_sur = torch.sum(S * mv(z)) / num_probes
        ld = ld_val + g_sur - g_sur.detach()
    return 0.5 * (quad + ld + n * math.log(2.0 * math.pi))


class GPRegression(BaseModel):
    """``GPRegression(x, y, kernel, noise_var=1.0, *, solver="cholesky", ...,
    seed=0, dtype=, device=)`` — the JAX package's constructor, with
    ``seed`` in place of ``key`` and ``dtype`` and ``device`` as the other
    models take them.

    ``kernel`` is one kernel module (a stationary or an ``extra`` kernel) or
    a per-dimension list; the parameters are ``kernel.*`` (``kernel.0.*``, …
    for a list) and ``log_noise``, in the JAX package's flat-vector order.

    ``solver="iterative"``: CG + SLQ (:func:`gp_nlml_iterative`) with
    ``num_probes``, ``lanczos_iters``, ``cg_tol``, ``cg_iters`` and
    ``precond_rank`` (pivoted-Cholesky whitening, 0 = off).
    ``matvec_chunk``: ``"auto"`` (the dense Gram up to n = 32768, the
    matrix-free operator beyond), a row-block size (matrix-free), or 0 (the
    dense Gram).  ``mixed16``: refined CG with a bf16 inner operator in the
    NLML and :meth:`log_likelihood_iterative_segmented` (not in
    :meth:`optimize_segmented`, whose solves run the exact operator, as in
    the JAX package).

    The iterative objective holds its probes fixed across evaluations (the
    sample-average approximation of the JAX package's fixed key): each
    evaluation draws them from a fresh ``torch.Generator`` seeded with
    ``seed``, so ``fit``'s convergence checks see a deterministic surface.
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
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if solver not in ("cholesky", "iterative"):
            raise ValueError("solver must be 'cholesky' or 'iterative'")
        dtype = _resolve_dtype(x, dtype)
        device = resolve_device(x, device)
        self.x, self.y = check_xy(_to_tensor(x, dtype, device), _to_tensor(y, dtype, device))
        self.solver = solver
        n = int(self.x.shape[0])
        if matvec_chunk == "auto":
            matvec_chunk = 0 if n <= 32768 else _auto_matvec_chunk(n)
        self._iter_opts = dict(
            num_probes=int(num_probes), lanczos_iters=int(lanczos_iters), cg_tol=float(cg_tol),
            cg_iters=int(cg_iters), precond_rank=int(precond_rank), matvec_chunk=int(matvec_chunk),
            mixed16=bool(mixed16),
        )
        self.seed = int(seed)
        # CG iterations of the last segmented NLML or optimize_segmented step,
        # as dispatched (None before one).
        self.cg_iterations: Optional[int] = None
        if _is_list(kernel):
            self.kernel = nn.ModuleList([copy.deepcopy(k).to(dtype=dtype, device=device) for k in kernel])
        else:
            self.kernel = copy.deepcopy(kernel).to(dtype=dtype, device=device)
        self.log_noise = nn.Parameter(inverse_positive(noise_var, dtype=dtype, device=device))
        if device.type == "cuda":
            # The JAX reference's dots are full float32; TF32 keeps ~3 digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    @property
    def noise_var(self) -> float:
        return float(torch.exp(self.log_noise.detach()))

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.x.device).manual_seed(self.seed)

    def _loss(self) -> torch.Tensor:
        if self.solver == "iterative":
            return gp_nlml_iterative(self.kernel, self.log_noise, self.x, self.y, generator=self._generator(),
                                     **self._iter_opts)
        return gp_nlml(self.kernel, self.log_noise, self.x, self.y)

    def _options(self, overrides: dict) -> dict:
        unknown = set(overrides) - set(_ITER_KEYS) - {"mixed16_slq"}
        if unknown:
            raise TypeError(f"unknown iterative options {sorted(unknown)}; expected some of {_ITER_KEYS}")
        return {**self._iter_opts, **overrides}

    def _gram_op(self, chunk: int, precision: str = "highest"):
        """The matrix-free ``K + σ²I`` at the current parameters."""
        return make_gram_matvec(self.kernel, self.x, torch.exp(self.log_noise), chunk=chunk, precision=precision)

    def _kern_fingerprint(self):
        """Value fingerprint of the hyperparameters, one ``bytes`` per leaf."""
        return tuple(p.detach().cpu().numpy().tobytes() for _, p in self._leaves())

    # -- the segmented host drivers ------------------------------------------------

    def log_likelihood_iterative_segmented(
        self,
        *,
        generator: Optional[torch.Generator] = None,
        cg_segment_iters: int = 50,
        probe_chunk: int = 8,
        fuse_probes: Optional[bool] = None,
        verbose: bool = False,
        **overrides,
    ) -> float:
        """Log marginal likelihood by CG + (whitened) SLQ on the matrix-free
        operator, through one host driver per path (JAX ``:415-618``):

        * fused (the default unless ``mixed16``):
          :func:`~gp_grief_tpu_torch.ops.fused.fused_cg_slq`, the probe
          chunks' applies advancing the solve;
        * separate: :func:`~gp_grief_tpu_torch.ops.cg.cg_segments`, then
          :func:`~gp_grief_tpu_torch.ops.lanczos.slq_logdet` per probe chunk;
        * ``mixed16``: the solve by
          :func:`~gp_grief_tpu_torch.ops.cg.cg_solve_refined` (bf16 inner
          operator and state), SLQ on the exact operator; ``mixed16_slq=True``
          (an override) runs SLQ on the bf16 operator too, and warns: the JAX
          package measured a catastrophic bias on smooth-kernel Grams.

        ``overrides`` replace the constructor's iterative options (and take
        ``mixed16_slq``).  ``generator`` draws the probes chunk by chunk
        (None: the model's seed).  ``cg_iterations`` holds the CG iterations
        dispatched.  Value only."""
        o = self._options(overrides)
        n = int(self.x.shape[0])
        dtype = self.y.dtype
        if generator is None:
            generator = self._generator()
        mixed16 = bool(o["mixed16"])
        mixed16_slq = bool(o.get("mixed16_slq", False)) and mixed16
        fuse = (not mixed16) if fuse_probes is None else bool(fuse_probes)
        if mixed16_slq:
            if fuse:
                warnings.warn("mixed16_slq has no effect with fuse_probes=True: the fused phase always runs SLQ "
                              "on the exact operator", stacklevel=2)
                mixed16_slq = False
            else:
                warnings.warn("mixed16_slq runs SLQ on the bf16 operator: the JAX package measured a catastrophic "
                              "NLML bias on smooth-kernel Grams (rel ~1.8 at n=2^17) -- trust it only after "
                              "measuring your operator's spectrum", stacklevel=2)
        chunk = int(o["matvec_chunk"]) or _auto_matvec_chunk(n)
        num_probes, k = int(o["num_probes"]), int(o["lanczos_iters"])
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            mv = self._gram_op(chunk)
            mv_fast = self._gram_op(chunk, "default") if mixed16 else None
            r = int(min(o["precond_rank"], n))
            if r > 0:
                _, M_inv_sqrt, logdet_M = _whitener(self.kernel, self.x, sigma2, r)
                op, rhs, ld_off = _whiten(mv, M_inv_sqrt, dtype), M_inv_sqrt(self.y[None, :]), float(logdet_M)
                op_fast = _whiten(mv_fast, M_inv_sqrt, dtype) if mixed16 else None
            else:
                op, op_fast, rhs, ld_off = mv, mv_fast, self.y[None, :], 0.0
            if fuse:
                sol, ld, iters = fused_cg_slq(
                    op, rhs, generator=generator, num_probes=num_probes, lanczos_iters=k, probe_chunk=probe_chunk,
                    cg_tol=float(o["cg_tol"]), cg_iters=int(o["cg_iters"]), cg_segment_iters=cg_segment_iters,
                    verbose=verbose,
                )
            else:
                if mixed16:
                    sol, info = cg_solve_refined(
                        op_fast, op, rhs, tol=float(o["cg_tol"]), inner_iters=int(cg_segment_iters),
                        max_restarts=max(1, -(-int(o["cg_iters"]) // int(cg_segment_iters))), layout="bm",
                        state_dtype=torch.bfloat16, return_info=True, implicit_diff=False,
                    )
                    iters = info.iterations + info.fallback_iterations
                else:
                    sol, iters = cg_segments(op, rhs, tol=float(o["cg_tol"]), max_iters=int(o["cg_iters"]),
                                             segment_iters=int(cg_segment_iters))
                slq_op = op_fast if mixed16_slq else op
                ld = 0.0
                for c in _lz._probe_chunk_sizes(num_probes, probe_chunk):
                    ld += c * float(_lz.slq_logdet(slq_op, n, generator=generator, num_probes=c, lanczos_iters=k,
                                                   dtype=dtype, device=self.x.device, layout="bm"))
                ld /= num_probes
            quad = float(torch.sum(rhs * sol))
        self.cg_iterations = iters
        return -0.5 * (quad + ld_off + ld + n * math.log(2.0 * math.pi))

    def optimize_segmented(
        self,
        max_iters: int = 10,
        *,
        learning_rate: float = 0.05,
        generator: Optional[torch.Generator] = None,
        cg_segment_iters: int = 25,
        probe_grad_chunk: int = 4,
        verbose: bool = False,
        callback=None,
        **overrides,
    ) -> FitResult:
        """Adam training one step at a time on the matrix-free operator (JAX
        ``:621-795``), each step:

        1. one batched solve, without a graph, of ``[y; Z]`` by
           :func:`~gp_grief_tpu_torch.ops.cg.cg_segments`, whitened with a
           pivoted-Cholesky factor rebuilt at the step's hyperparameters when
           ``precond_rank > 0``;
        2. the BBMM surrogate gradient in pieces, each a forward and a
           backward through the differentiated operator of
           :func:`make_gram_matvec` (K9 and K10 on the card, checkpointed
           slabs elsewhere): the quadratic piece ``−αᵀ(∂Ã)α`` and the
           Hutchinson pieces ``Σ s_rᵀ(∂Ã)z_r / R`` in ``probe_grad_chunk``
           chunks;
        3. a ``torch.optim.Adam`` update (ε = 1e-8, as ``fit``'s).

        The probes ``Z`` are one draw for the whole run (the JAX package's
        fixed key; None: the model's seed, so the monolithic loss sees the
        same ``z``).  The solves run the exact operator whatever ``mixed16``
        says, as in the JAX package.  Parameters held by :meth:`fix` get a
        zero gradient.  ``losses`` trace the data-fit surrogate ``½ yᵀα +
        (n/2) log 2π`` (the SLQ value is never computed in a step);
        ``callback(step, surrogate, info)`` gets ``info`` with the step's
        ``cg_iterations``.  Under a profiler each step is the span
        ``gp_grief.model.step`` with its ``.solve`` and ``.grad``
        (:mod:`~gp_grief_tpu_torch.utils.profiling`).  Raises ``ValueError`` unless the
        model is iterative and matrix-free."""
        o = self._options(overrides)
        chunk = int(o["matvec_chunk"])
        if self.solver != "iterative" or chunk <= 0:
            raise ValueError("optimize_segmented needs solver='iterative' and a matrix-free operator "
                             "(matvec_chunk > 0); use optimize() for the dense and small-n paths")
        n = int(self.x.shape[0])
        R = int(o["num_probes"])
        r = int(min(o["precond_rank"], n))
        dtype = self.y.dtype
        if generator is None:
            generator = self._generator()
        Z = _lz.rademacher((R, n), dtype=dtype, device=self.x.device, generator=generator)
        rhs0 = torch.cat([self.y[None, :], Z], dim=0)
        sizes = _lz._probe_chunk_sizes(R, probe_grad_chunk)
        named = list(self._leaves())
        params = [p for _, p in named]
        fixed = self._fixed_mask() or {}
        frozen = [p for name, p in named if fixed.get(name, False)]
        opt = torch.optim.Adam(params, lr=learning_rate, eps=1e-8)
        losses, gnorms = [], []
        t0 = time.perf_counter()
        for step in range(int(max_iters)):
            with _step_span(step):
                with torch.no_grad(), _step_solve_span():
                    sigma2 = torch.exp(self.log_noise)
                    mv = self._gram_op(chunk)
                    if r > 0:
                        _, M_inv_sqrt, _ = _whitener(self.kernel, self.x, sigma2, r)
                        solw, iters = cg_segments(_whiten(mv, M_inv_sqrt, dtype), M_inv_sqrt(rhs0),
                                                  tol=float(o["cg_tol"]), max_iters=int(o["cg_iters"]),
                                                  segment_iters=int(cg_segment_iters))
                        sol = M_inv_sqrt(solw)
                    else:
                        sol, iters = cg_segments(mv, rhs0, tol=float(o["cg_tol"]), max_iters=int(o["cg_iters"]),
                                                 segment_iters=int(cg_segment_iters))
                    alpha, S = sol[0], sol[1:]
                    fit_sur = 0.5 * (torch.dot(self.y, alpha) + n * math.log(2.0 * math.pi))
                    with _prof.host_read("model.step.loss"):
                        fit_sur = float(fit_sur)
                with _step_grad_span():
                    opt.zero_grad(set_to_none=True)
                    # One operator per piece: each backward frees its graph, σ²'s included.
                    (-0.5 * torch.dot(alpha, self._gram_op(chunk)(alpha[None, :])[0])).backward()
                    off = 0
                    for c in sizes:
                        (0.5 * torch.sum(S[off : off + c] * self._gram_op(chunk)(Z[off : off + c])) / R).backward()
                        off += c
                    for p in frozen:
                        if p.grad is not None:
                            p.grad.zero_()
                    gn = torch.sqrt(sum(p.grad.double().pow(2).sum() for p in params if p.grad is not None))
                    with _prof.host_read("model.step.grad_norm"):
                        gn = float(gn)
                opt.step()
            self.cg_iterations = iters
            losses.append(fit_sur)
            gnorms.append(gn)
            if verbose:
                print(f"[optimize_segmented] step {step + 1}/{max_iters}: data-fit {fit_sur:.4f} |g| {gn:.3e} "
                      f"({iters} CG iterations)", flush=True)
            if callback is not None:
                callback(step, fit_sur, {"cg_iterations": iters})
        return FitResult(
            losses=np.asarray(losses), grad_norms=np.asarray(gnorms), iterations=len(losses),
            wall_time=time.perf_counter() - t0, converged=False, opt_state=opt.state_dict(),
        )

    # -- prediction ----------------------------------------------------------------------

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
        variance ``k(x*, x*) − K_*X K̃⁻¹ K_X*`` clamped at 0 (plus σ² with
        ``include_noise``).  On the matrix-free operator (``solver=
        "iterative"``, ``matvec_chunk > 0``) by CG
        (:meth:`_predict_iterative`, test chunks of ``chunk`` points, 0 for
        automatic); otherwise by the Cholesky factor.  Returns tensors on the
        model's device."""
        x_new = _to_tensor(x_new, self.x.dtype, self.x.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        if self.solver == "iterative" and self._iter_opts["matvec_chunk"] > 0:
            return self._predict_iterative(x_new, compute_var, include_noise, test_chunk=chunk)
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

    def _predict_iterative(self, x_new, compute_var: bool, include_noise: bool, *, test_chunk: int = 0):
        """Matrix-free prediction (JAX ``:854-962``): no ``(n, n)`` buffer; the
        largest live tensors are a ``(chunk, n)`` cross-covariance block and
        the CG state.  The representer weights ``α`` and the preconditioner
        factor are cached per hyperparameter values (``(fingerprint, L, α)``),
        so repeated calls at one optimum pay only the per-chunk work: one
        cross-covariance block and, for the exact variances, one batched
        whitened solve per chunk of test points."""
        o = self._iter_opts
        n = int(self.x.shape[0])
        n_star = int(x_new.shape[0])
        if n_star == 0:
            empty = torch.zeros((0,), dtype=self.y.dtype, device=self.x.device)
            return empty if not compute_var else (empty, empty.clone())
        seg_iters = 50
        r = int(min(o["precond_rank"], n))
        fp = self._kern_fingerprint()
        cached = getattr(self, "_pred_cache", None)
        hit = cached is not None and cached[0] == fp
        with torch.no_grad():
            sigma2 = torch.exp(self.log_noise)
            op = mv = self._gram_op(o["matvec_chunk"])
            Lpc, M_inv_sqrt = (cached[1] if hit else None), None
            if r > 0:
                Lpc, M_inv_sqrt, _ = _whitener(self.kernel, self.x, sigma2, r, Lpc=Lpc)
                op = _whiten(mv, M_inv_sqrt, self.y.dtype)

            def solve_bm(rhs_bm):
                b = rhs_bm if M_inv_sqrt is None else M_inv_sqrt(rhs_bm)
                w, _ = cg_segments(op, b, tol=o["cg_tol"], max_iters=o["cg_iters"], segment_iters=seg_iters)
                return w if M_inv_sqrt is None else M_inv_sqrt(w)

            if hit:
                alpha = cached[2]
            else:
                alpha = solve_bm(self.y[None, :])[0]
                self._pred_cache = (fp, Lpc, alpha)
            if test_chunk <= 0:
                # A (chunk, n) block and ~5 CG buffers of its shape: at most
                # 2^27 elements, a multiple of 8 rows.
                test_chunk = int(max(8, min(1024, (1 << 27) // max(n, 1))))
                test_chunk -= test_chunk % 8
            test_chunk = min(test_chunk, n_star)
            means, vars_ = [], []
            for s in range(0, n_star, test_chunk):
                xc = x_new[s : s + test_chunk]
                Ks = _cov_any(self.kernel, xc, self.x)  # (c, n)
                means.append(Ks @ alpha)
                if compute_var:
                    Zs = solve_bm(Ks)  # (K + σ²I)⁻¹ K_X*, one row per test point
                    vars_.append(torch.clamp_min(cov_diag(self.kernel, xc) - torch.sum(Ks * Zs, dim=1), 0.0))
            mean = torch.cat(means)
            if not compute_var:
                return mean
            var = torch.cat(vars_)
            if include_noise:
                var = var + sigma2
        return mean, var
