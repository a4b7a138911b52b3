"""Kernels K9 and K10: the matrix-free Gram apply ``vv ↦ vv (K + σ²I)`` of
one stationary kernel on the card, in one pass with no slab of ``K`` in
device memory (K9), and the cotangents of its hyperparameters (K10).

Neither replaces a TPU kernel (the JAX package leaves the apply to XLA and
its gradient to XLA's autodiff); the CUDA sources are ``csrc/gram_apply.cu``
and ``csrc/gram_grad.cu``.  K9 is the solver role of
:func:`~gp_grief_tpu_torch.models.gp_regression.make_gram_matvec` wherever
:func:`fused_route` holds; there its differentiated role is
:class:`GramApply`, K9's forward with K10 in the backward.
:func:`gram_apply` and :func:`gram_grad` check their operands and then

* on CPU tensors run the plain versions :func:`gram_apply_ref` and
  :func:`gram_grad_ref`, which repeat the kernels' arithmetic (direct
  differences; the variance and ``σ² vv`` applied after the sum; K10's sums
  folded into float64);
* on CUDA tensors launch the kernel on the current stream, or raise.  They
  never fall back to the plain version on the card.

The kernels' members are instantiated for ``D`` in :data:`DIMS` coordinates
(``d`` is zero-padded up to the next one) and ``B`` tiles in :data:`B_TILES`
(K9) or :data:`GRAD_B_TILES` (K10); :func:`plan` and :func:`grad_plan` set a
call's member and shapes: :func:`b_tile` cuts ``B`` into tiles and
:func:`splits` picks how many blocks share each row tile's columns, from the
member's occupancy on the card.  ``gram_apply.launches`` and
``gram_grad.launches`` count the calls launched (each one or two kernels)
and nothing else.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gp_grief_tpu_torch.kernels.stationary import Stationary, _from_r2
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["fused_route", "gram_apply", "gram_apply_ref", "gram_grad", "gram_grad_ref", "GramApply", "b_tile",
           "splits", "plan", "grad_plan", "Plan", "MAX_DIM"]

_SYMBOLS = {torch.float32: "gp_grief_gram_apply_f32", torch.float64: "gp_grief_gram_apply_f64"}
_GRAD_SYMBOLS = {torch.float32: "gp_grief_gram_grad_f32", torch.float64: "gp_grief_gram_grad_f64"}
# The kernel's code of each kind (exponential and matern12 are one function).
KINDS = {"rbf": 0, "exponential": 1, "matern12": 1, "matern32": 2, "matern52": 3}
DIMS = (2, 4, 8)
MAX_DIM = DIMS[-1]
# 1: the mean solve; 9: the 1 + 8 probe rows of the recipes' solves; 16: wider
# blocks (predictive variances).  Any other B runs on the next tile up.
B_TILES = (1, 9, 16)
# K10's: 1, the quadratic piece; 4 and 8, the probe-gradient chunks; 16,
# wider ones (gp_nlml_iterative's num_probes, 32 by default, as 2 x 16).
GRAD_B_TILES = (1, 4, 8, 16)
ROW_PAD = 512  # the kernel's n_pad multiple (csrc/gram_apply.cu)
COLUMN_TILE = 64  # the kernel's columns a stage
THREADS = 128
# Split the columns while the row tiles fill fewer waves of the card than this.
WAVES = 2
REF_ROWS = 1024  # rows of K the plain version holds at a time


def fused_route(kernels, device_type: str, dtype: torch.dtype, d: int) -> bool:
    """Whether the apply of ``kernels`` on ``(n, d)`` inputs of ``dtype`` on
    a ``device_type`` device runs on K9 (its solver role; differentiated, K9
    and K10 through :class:`GramApply`): one
    :class:`~gp_grief_tpu_torch.kernels.stationary.Stationary` of a kind the
    kernel has, its parameters in ``dtype``, float32 or float64 on a CUDA
    device, and ``1 ≤ d ≤`` :data:`MAX_DIM`.  Everything else (products of
    kernels, the ``extra`` kernels, CPU tensors, bf16 state, wider inputs)
    keeps the slab path."""
    return (isinstance(kernels, Stationary) and kernels.kind in KINDS and device_type == "cuda"
            and dtype in _SYMBOLS and kernels.log_lengthscale.dtype == dtype and 1 <= int(d) <= MAX_DIM)


def b_tile(B: int, tiles=B_TILES) -> int:
    """The member's ``B`` tile: ``B`` cut into ``ceil(B / 16)`` near-equal
    tiles, each rounded up to the next of ``tiles`` (K9's :data:`B_TILES`,
    or K10's :data:`GRAD_B_TILES`)."""
    per = -(-B // -(-B // tiles[-1]))
    return next(t for t in tiles if t >= per)


def splits(ctas: int, slots: int, tiles: int) -> int:
    """Blocks sharing each row tile's column range: 1 where the ``ctas``
    row-and-B tiles fill :data:`WAVES` waves of ``slots`` resident blocks;
    otherwise the ``S`` (at most ``tiles``, the column tiles, and 64) that
    takes the fewest column tiles a block times waves,
    ``ceil(ctas·S / slots) · ceil(tiles / S)``, the smallest on a tie."""
    if ctas >= WAVES * slots:
        return 1
    cost = {s: -(-ctas * s // slots) * -(-tiles // s) for s in range(1, min(tiles, 64) + 1)}
    return min(cost, key=lambda s: (cost[s], s))


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _operands(kernel: Stationary, x: torch.Tensor, sigma2):
    """The lengthscales (``(d,)``), the variance and ``σ²``, in ``x``'s dtype,
    with no graph and no host read."""
    d = x.shape[1]
    ls = torch.broadcast_to(kernel.lengthscale.detach(), (d,)).to(x.dtype)
    var = kernel.variance.detach().to(x.dtype).reshape(1)
    sig = torch.as_tensor(sigma2, device=x.device).detach().to(x.dtype).reshape(1)
    return ls, var, sig


def _apply_ref(kind: str, x, ls, var, sig, vv, fast: bool) -> torch.Tensor:
    xs = x / ls
    vr = _round_bf16(vv) if fast else vv
    one = torch.ones((), dtype=x.dtype, device=x.device)
    outs = []
    for xb in xs.split(REF_ROWS):
        diff = xb[:, None, :] - xs[None, :, :]
        g = _from_r2(kind, one, torch.sum(diff * diff, dim=-1))
        outs.append(vr @ _round_bf16(var * g).T if fast else var * (vr @ g.T))
    return torch.cat(outs, dim=1) + sig * vv


def gram_apply_ref(kernel: Stationary, x: torch.Tensor, vv: torch.Tensor, sigma2,
                   precision: str = "highest") -> torch.Tensor:
    """The plain version: K9's arithmetic by PyTorch ops, :data:`REF_ROWS`
    rows of ``K`` at a time.  ``"highest"``: ``var · (vv gᵀ) + σ² vv``; ``"default"``:
    ``round(vv) round(var · g)ᵀ + σ² vv``, each rounded operand bf16."""
    return _apply_ref(kernel.kind, x, *_operands(kernel, x, sigma2), vv, precision == "default")


def _g_and_h(kind: str, r2: torch.Tensor):
    """``g(r²)`` and ``h(r²) = −2 g'(r²)`` of the kind, ``h`` from ``g``'s
    exponential; matern12's ``h`` is 0 where ``r² = 0``."""
    if kind == "rbf":
        g = torch.exp(-0.5 * r2)
        return g, g
    pos = r2 > 0
    r = torch.sqrt(r2)
    if kind in ("exponential", "matern12"):
        g = torch.exp(-r)
        return g, torch.where(pos, g / torch.where(pos, r, torch.ones_like(r)), torch.zeros_like(r))
    if kind == "matern32":
        s = 3.0**0.5 * r
        e = torch.exp(-s)
        return (1.0 + s) * e, 3.0 * e
    s = 5.0**0.5 * r
    e = torch.exp(-s)
    return (1.0 + s + s * s / 3.0) * e, (5.0 / 3.0) * (1.0 + s) * e


def _grad_scale(sums: torch.Tensor, ls: torch.Tensor, var: torch.Tensor, dtype: torch.dtype):
    """``(∂L/∂var, ∂L/∂ℓ)`` from K10's float64 sums ``[c_var, c_1 .. c_d]``:
    ``c_var`` and ``var · c_d / ℓ_d``."""
    d = ls.shape[0]
    return sums[0].to(dtype), (var.double().reshape(()) * sums[1 : 1 + d] / ls.double()).to(dtype)


def gram_grad_ref(kind: str, x: torch.Tensor, G: torch.Tensor, vv: torch.Tensor, ls: torch.Tensor,
                  var: torch.Tensor):
    """The plain version of K10: ``(∂L/∂var, ∂L/∂ℓ)`` of ``L = Σ G ⊙ (vv K)``,
    ``K = var · g(r²)`` on ``x / ℓ``, by PyTorch ops, :data:`REF_ROWS` rows
    at a time: each row's sums over the columns in ``x``'s dtype, the rows'
    added in float64.  ``ℓ`` is ``(d,)``; the results are in ``x``'s
    dtype."""
    d = x.shape[1]
    xs = x / ls
    sums = torch.zeros(d + 1, dtype=torch.float64, device=x.device)
    for xb, Gb in zip(xs.split(REF_ROWS), G.split(REF_ROWS, dim=1)):
        diff = xb[:, None, :] - xs[None, :, :]
        s2 = diff * diff
        g, h = _g_and_h(kind, torch.sum(s2, dim=-1))
        w = Gb.T @ vv  # w_ij = Σ_b G[b, i] vv[b, j]
        sums[0] += torch.sum(w * g, dim=1).double().sum()
        sums[1:] += torch.sum((w * h)[:, :, None] * s2, dim=1).double().sum(dim=0)
    return _grad_scale(sums, ls, var, x.dtype)


@functools.lru_cache(maxsize=None)
def _slots(query: str, device: int, *member: int) -> int:
    """Blocks of one member resident on the whole card, by the library's
    occupancy ``query`` (K9's or K10's) of ``member``'s codes."""
    from gp_grief_tpu_torch.ops.cuda import _build

    per_sm = getattr(_build.load_library(), query)(*member, device)
    if per_sm <= 0:
        raise RuntimeError(f"{query} failed ({per_sm}) for {member}")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


class Plan(NamedTuple):
    """How K9 or K10 runs one ``(n, d, B)``: the member's coordinates ``D``
    and ``B`` tile ``BT`` (``nbt`` tiles, each padded to ``BTP`` values a
    point in memory), the padded point count ``n_pad`` and the column splits
    ``S``."""

    D: int
    BT: int
    nbt: int
    BTP: int
    n_pad: int
    S: int


def _rows(dtype: torch.dtype, D: int) -> int:
    """Rows of a block: 128 threads of 4 rows, or 2 in double and past 4
    coordinates (the kernels' ``rows_of``)."""
    return THREADS * (2 if (dtype == torch.float64 or D > 4) else 4)


def _plan(n: int, d: int, B: int, dtype: torch.dtype, tiles, slots) -> Plan:
    size = torch.finfo(dtype).bits // 8
    D = next(k for k in DIMS if k >= d)
    BT = b_tile(B, tiles)
    nbt = -(-B // BT)
    BTP = 1 if BT == 1 else -(-BT * size // 16) * 16 // size
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    S = splits((n_pad // _rows(dtype, D)) * nbt, slots(D, BT), n_pad // COLUMN_TILE)
    return Plan(D, BT, nbt, BTP, n_pad, S)


def plan(n: int, d: int, B: int, dtype: torch.dtype, kind: str, fast: bool, device: int) -> Plan:
    """K9's plan on card ``device`` (its occupancy sets ``S``)."""
    f64 = int(dtype == torch.float64)
    return _plan(n, d, B, dtype, B_TILES,
                 lambda D, BT: _slots("gp_grief_gram_occupancy", device, f64, KINDS[kind], D, BT, int(fast)))


def grad_plan(n: int, d: int, B: int, dtype: torch.dtype, kind: str, device: int) -> Plan:
    """K10's plan on card ``device``: :data:`GRAD_B_TILES`, and ``S`` from
    K10's occupancy."""
    f64 = int(dtype == torch.float64)
    return _plan(n, d, B, dtype, GRAD_B_TILES,
                 lambda D, BT: _slots("gp_grief_gram_grad_occupancy", device, f64, KINDS[kind], D, BT))


def _tiles(v: torch.Tensor, p: Plan) -> torch.Tensor:
    """``v`` ``(B, n)`` as the kernels read it: ``(nbt, n_pad, BTP)``, tile
    by tile, point-major, zero-padded."""
    B, n = v.shape
    vt = F.pad(v, (0, p.n_pad - n, 0, p.nbt * p.BT - B))
    vt = vt.view(p.nbt, p.BT, p.n_pad).transpose(1, 2)
    return F.pad(vt, (0, p.BTP - p.BT)) if p.BTP != p.BT else vt.contiguous()


def _launch(kind: str, x: torch.Tensor, ls, var, sig, vv: torch.Tensor, fast: bool) -> torch.Tensor:
    from gp_grief_tpu_torch.ops.cuda import _build

    (n, d), B = x.shape, int(vv.shape[0])
    out = torch.empty((B, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    device = x.device.index
    p = plan(n, d, B, x.dtype, kind, fast, device)
    xs = F.pad(x / ls, (0, p.D - d, 0, p.n_pad - n))
    vv = vv.contiguous()
    vt = _tiles(_round_bf16(vv) if fast else vv, p)
    part = torch.empty((p.S, B, p.n_pad), dtype=x.dtype, device=x.device) if p.S > 1 else None
    fn = getattr(_build.load_library(), _SYMBOLS[x.dtype])
    err = fn(xs.data_ptr(), vt.data_ptr(), vv.data_ptr(), var.data_ptr(), sig.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), n, p.n_pad, B, p.D, KINDS[kind], p.BT, int(fast),
             p.S, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"gram_apply kernel launch failed with cudaError {err} at (B, n, d) = {(B, n, d)}, {p}")
    gram_apply.launches += 1
    return out


def _check(name: str, x: torch.Tensor, *vs: torch.Tensor) -> None:
    for v in vs:
        if x.ndim != 2 or v.ndim != 2 or v.shape[1] != x.shape[0]:
            raise ValueError(f"{name}: x must be (n, d) and each vector block (B, n), got {tuple(x.shape)} "
                             f"and {tuple(v.shape)}")
        if v.dtype != x.dtype or v.device != x.device:
            raise TypeError(f"{name}: x is {x.dtype} on {x.device}, a vector block {v.dtype} on {v.device}")


def gram_apply(kernel: Stationary, x: torch.Tensor, vv: torch.Tensor, sigma2, precision: str = "highest"):
    """``vv (K + σ²I)`` for ``vv`` ``(B, n)``, ``K = kernel(x, x)``, ``x``
    ``(n, d)`` and ``vv`` of one float dtype on one device; ``sigma2`` a
    number or a 0-d tensor.  ``precision``: ``"highest"`` or ``"default"``
    (the bf16-operand contraction).  Values only: no graph."""
    if precision not in ("highest", "default"):
        raise ValueError("precision must be 'highest' or 'default'")
    _check("gram_apply", x, vv)
    with torch.no_grad():
        if x.device.type == "cpu":
            return gram_apply_ref(kernel, x, vv, sigma2, precision)
        if not fused_route(kernel, x.device.type, x.dtype, x.shape[1]):
            raise ValueError(f"gram_apply: no kernel for {kernel!r} on {x.device}, {x.dtype}, d = {x.shape[1]}")
        return _launch(kernel.kind, x, *_operands(kernel, x, sigma2), vv, precision == "default")


gram_apply.launches = 0


def _grad_launch(kind: str, x: torch.Tensor, G: torch.Tensor, vv: torch.Tensor, ls, var):
    from gp_grief_tpu_torch.ops.cuda import _build

    (n, d), B = x.shape, int(G.shape[0])
    device = x.device.index
    p = grad_plan(n, d, B, x.dtype, kind, device)
    xs = F.pad(x / ls, (0, p.D - d, 0, p.n_pad - n))
    gt, vt = _tiles(G, p), _tiles(vv, p)
    part = torch.empty(((p.n_pad // _rows(x.dtype, p.D)) * p.nbt * p.S, p.D + 1), dtype=torch.float64,
                       device=x.device)
    sums = torch.empty(p.D + 1, dtype=torch.float64, device=x.device)
    fn = getattr(_build.load_library(), _GRAD_SYMBOLS[x.dtype])
    err = fn(xs.data_ptr(), gt.data_ptr(), vt.data_ptr(), part.data_ptr(), sums.data_ptr(), p.n_pad, B, p.D,
             KINDS[kind], p.BT, p.S, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"gram_grad kernel launch failed with cudaError {err} at (B, n, d) = {(B, n, d)}, {p}")
    gram_grad.launches += 1
    return _grad_scale(sums, ls, var, x.dtype)


def gram_grad(kind: str, x: torch.Tensor, G: torch.Tensor, vv: torch.Tensor, ls: torch.Tensor,
              var: torch.Tensor):
    """``(∂L/∂var, ∂L/∂ℓ)`` of ``L = Σ G ⊙ (vv K)`` for the stationary kernel
    ``K = var · g(r²)`` of ``kind`` on ``x / ℓ``: ``x`` ``(n, d)``, the
    cotangent ``G`` and ``vv`` ``(B, n)``, ``ℓ`` ``(d,)`` and ``var`` (one
    value), all of one float dtype on one device.  Values only: no graph."""
    _check("gram_grad", x, G, vv)
    if G.shape[0] != vv.shape[0] or ls.shape != (x.shape[1],) or var.numel() != 1:
        raise ValueError(f"gram_grad: G {tuple(G.shape)} and vv {tuple(vv.shape)} must match, ℓ be "
                         f"({x.shape[1]},) and var one value, got {tuple(ls.shape)} and {tuple(var.shape)}")
    with torch.no_grad():
        if x.device.type == "cpu":
            return gram_grad_ref(kind, x, G, vv, ls, var)
        if kind not in KINDS or x.dtype not in _GRAD_SYMBOLS or not 1 <= x.shape[1] <= MAX_DIM:
            raise ValueError(f"gram_grad: no kernel for {kind!r} on {x.device}, {x.dtype}, d = {x.shape[1]}")
        if G.shape[0] == 0 or x.shape[0] == 0:
            return torch.zeros((), dtype=x.dtype, device=x.device), torch.zeros_like(ls)
        return _grad_launch(kind, x, G, vv, ls, var)


gram_grad.launches = 0

_grad_span = _prof.site("gp_grief.gram.grad", "B", "n")


def _apply_no_noise(kind: str, x: torch.Tensor, ls, var, vv: torch.Tensor) -> torch.Tensor:
    """``vv K`` (``σ² = 0``) at "highest": K9 on the card, its plain version
    on the CPU."""
    sig = torch.zeros(1, dtype=x.dtype, device=x.device)
    ls, var = ls.detach(), var.detach().reshape(1)
    if x.device.type == "cpu":
        return _apply_ref(kind, x, ls, var, sig, vv, False)
    return _launch(kind, x, ls, var, sig, vv, False)


class GramApply(torch.autograd.Function):
    """``vv ↦ vv K`` (no ``σ²`` term) with its gradient, the differentiated
    role of :func:`~gp_grief_tpu_torch.models.gp_regression.make_gram_matvec`
    where :func:`fused_route` holds: ``apply(kind, x, vv, ls, var)``, ``ls``
    ``(d,)``.  The forward is K9 (:func:`gram_apply` with ``σ² = 0``); the
    backward takes the cotangents of ``ls`` and ``var`` from one K10 call
    (:func:`gram_grad`), and ``vv``'s, ``G K`` (``K`` is symmetric), from
    one more K9 call; each only where its inputs require grad.  ``x`` gets
    none.  Under a profiler the backward is the span ``gp_grief.gram.grad``
    (attributes ``B``, ``n``), and each K10 call adds 1 to the counter
    ``gram_fused_grads``."""

    @staticmethod
    def forward(ctx, kind: str, x, vv, ls, var):
        ctx.kind = kind
        ctx.save_for_backward(x, vv, ls, var)
        return _apply_no_noise(kind, x, ls, var, vv)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        x, vv, ls, var = ctx.saved_tensors
        with _grad_span(int(G.shape[0]), int(x.shape[0])):
            G = G.contiguous()
            c_var = c_ls = g_vv = None
            if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
                _prof.count("gram_fused_grads")
                c_var, c_ls = gram_grad(ctx.kind, x, G, vv, ls, var)
                c_var = c_var.reshape(var.shape)
            if ctx.needs_input_grad[2]:
                g_vv = _apply_no_noise(ctx.kind, x, ls, var, G)
        return None, None, g_vv, c_ls, c_var
