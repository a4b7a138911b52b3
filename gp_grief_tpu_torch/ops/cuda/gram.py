"""Kernel K9: the matrix-free Gram apply ``vv ↦ vv (K + σ²I)`` of one
stationary kernel on the card, in one pass with no slab of ``K`` in device
memory.

Replaces no TPU kernel (the JAX package leaves the apply to XLA); the CUDA
source is ``csrc/gram_apply.cu``.  It is the solver role of
:func:`~gp_grief_tpu_torch.models.gp_regression.make_gram_matvec` wherever
:func:`fused_route` holds.  :func:`gram_apply` checks its operands and then

* on CPU tensors runs the plain version :func:`gram_apply_ref`, which
  repeats the kernel's arithmetic (direct differences; the variance and
  ``σ² vv`` applied after the sum);
* on CUDA tensors launches the kernel on the current stream, or raises.  It
  never falls back to the plain version on the card.

The kernel's members are instantiated for ``D`` in :data:`DIMS` coordinates
(``d`` is zero-padded up to the next one) and ``B`` tiles in
:data:`B_TILES`; :func:`plan` sets a call's member and shapes: :func:`b_tile`
cuts ``B`` into tiles and :func:`splits` picks how many blocks share each row
tile's columns, from the member's occupancy on the card.  ``gram_apply.launches`` counts applies launched
(each one or two kernels) and nothing else.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gp_grief_tpu_torch.kernels.stationary import Stationary, _from_r2

__all__ = ["fused_route", "gram_apply", "gram_apply_ref", "b_tile", "splits", "plan", "Plan", "MAX_DIM"]

_SYMBOLS = {torch.float32: "gp_grief_gram_apply_f32", torch.float64: "gp_grief_gram_apply_f64"}
# The kernel's code of each kind (exponential and matern12 are one function).
KINDS = {"rbf": 0, "exponential": 1, "matern12": 1, "matern32": 2, "matern52": 3}
DIMS = (2, 4, 8)
MAX_DIM = DIMS[-1]
# 1: the mean solve; 9: the 1 + 8 probe rows of the recipes' solves; 16: wider
# blocks (predictive variances).  Any other B runs on the next tile up.
B_TILES = (1, 9, 16)
ROW_PAD = 512  # the kernel's n_pad multiple (csrc/gram_apply.cu)
COLUMN_TILE = 64  # the kernel's columns a stage
THREADS = 128
# Split the columns while the row tiles fill fewer waves of the card than this.
WAVES = 2
REF_ROWS = 1024  # rows of K the plain version holds at a time


def fused_route(kernels, device_type: str, dtype: torch.dtype, d: int) -> bool:
    """Whether the solver-role apply of ``kernels`` on ``(n, d)`` inputs of
    ``dtype`` on a ``device_type`` device runs on K9: one
    :class:`~gp_grief_tpu_torch.kernels.stationary.Stationary` of a kind the
    kernel has, its parameters in ``dtype``, float32 or float64 on a CUDA
    device, and ``1 ≤ d ≤`` :data:`MAX_DIM`.  Everything else (products of
    kernels, the ``extra`` kernels, CPU tensors, bf16 state, wider inputs)
    keeps the slab path."""
    return (isinstance(kernels, Stationary) and kernels.kind in KINDS and device_type == "cuda"
            and dtype in _SYMBOLS and kernels.log_lengthscale.dtype == dtype and 1 <= int(d) <= MAX_DIM)


def b_tile(B: int) -> int:
    """The member's ``B`` tile: ``B`` cut into ``ceil(B / 16)`` near-equal
    tiles, each rounded up to the next of :data:`B_TILES`."""
    per = -(-B // -(-B // B_TILES[-1]))
    return next(t for t in B_TILES if t >= per)


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
    """The scaled inputs, the variance and ``σ²``, in ``x``'s dtype, with no
    graph and no host read."""
    d = x.shape[1]
    ls = torch.broadcast_to(kernel.lengthscale.detach(), (d,)).to(x.dtype)
    var = kernel.variance.detach().to(x.dtype).reshape(1)
    sig = torch.as_tensor(sigma2, device=x.device).detach().to(x.dtype).reshape(1)
    return x / ls, var, sig


def gram_apply_ref(kernel: Stationary, x: torch.Tensor, vv: torch.Tensor, sigma2,
                   precision: str = "highest") -> torch.Tensor:
    """The plain version: K9's arithmetic by PyTorch ops, :data:`REF_ROWS`
    rows of ``K`` at a time.  ``"highest"``: ``var · (vv gᵀ) + σ² vv``; ``"default"``:
    ``round(vv) round(var · g)ᵀ + σ² vv``, each rounded operand bf16."""
    xs, var, sig = _operands(kernel, x, sigma2)
    fast = precision == "default"
    vr = _round_bf16(vv) if fast else vv
    one = torch.ones((), dtype=x.dtype, device=x.device)
    outs = []
    for xb in xs.split(REF_ROWS):
        diff = xb[:, None, :] - xs[None, :, :]
        g = _from_r2(kernel.kind, one, torch.sum(diff * diff, dim=-1))
        outs.append(vr @ _round_bf16(var * g).T if fast else var * (vr @ g.T))
    return torch.cat(outs, dim=1) + sig * vv


@functools.lru_cache(maxsize=None)
def _slots(device: int, dtype: torch.dtype, kind: int, D: int, BT: int, fast: bool) -> int:
    """Blocks of one member resident on the whole card."""
    from gp_grief_tpu_torch.ops.cuda import _build

    per_sm = _build.load_library().gp_grief_gram_occupancy(int(dtype == torch.float64), kind, D, BT, int(fast),
                                                            device)
    if per_sm <= 0:
        raise RuntimeError(f"gram_apply: occupancy query failed ({per_sm}) for {(dtype, kind, D, BT, fast)}")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


class Plan(NamedTuple):
    """How K9 runs one ``(n, d, B)``: the member's coordinates ``D`` and
    ``B`` tile ``BT`` (``nbt`` tiles, each padded to ``BTP`` values a point
    in memory), the padded point count ``n_pad`` and the column splits
    ``S``."""

    D: int
    BT: int
    nbt: int
    BTP: int
    n_pad: int
    S: int


def plan(n: int, d: int, B: int, dtype: torch.dtype, kind: str, fast: bool, device: int) -> Plan:
    """K9's plan on card ``device`` (its occupancy sets ``S``)."""
    size = torch.finfo(dtype).bits // 8
    D = next(k for k in DIMS if k >= d)
    BT = b_tile(B)
    nbt = -(-B // BT)
    BTP = 1 if BT == 1 else -(-BT * size // 16) * 16 // size
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    rows = THREADS * (2 if (size == 8 or D > 4) else 4)
    S = splits((n_pad // rows) * nbt, _slots(device, dtype, KINDS[kind], D, BT, fast), n_pad // COLUMN_TILE)
    return Plan(D, BT, nbt, BTP, n_pad, S)


def _launch(kernel: Stationary, x: torch.Tensor, vv: torch.Tensor, sigma2, fast: bool) -> torch.Tensor:
    from gp_grief_tpu_torch.ops.cuda import _build

    (n, d), B = x.shape, int(vv.shape[0])
    out = torch.empty((B, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    device = x.device.index
    p = plan(n, d, B, x.dtype, kernel.kind, fast, device)
    xs, var, sig = _operands(kernel, x, sigma2)
    xs = F.pad(xs, (0, p.D - d, 0, p.n_pad - n))
    vv = vv.contiguous()
    vt = F.pad(_round_bf16(vv) if fast else vv, (0, p.n_pad - n, 0, p.nbt * p.BT - B))
    vt = vt.view(p.nbt, p.BT, p.n_pad).transpose(1, 2)
    vt = F.pad(vt, (0, p.BTP - p.BT)) if p.BTP != p.BT else vt.contiguous()
    part = torch.empty((p.S, B, p.n_pad), dtype=x.dtype, device=x.device) if p.S > 1 else None
    fn = getattr(_build.load_library(), _SYMBOLS[x.dtype])
    err = fn(xs.data_ptr(), vt.data_ptr(), vv.data_ptr(), var.data_ptr(), sig.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), n, p.n_pad, B, p.D, KINDS[kernel.kind], p.BT, int(fast),
             p.S, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"gram_apply kernel launch failed with cudaError {err} at (B, n, d) = {(B, n, d)}, {p}")
    gram_apply.launches += 1
    return out


def gram_apply(kernel: Stationary, x: torch.Tensor, vv: torch.Tensor, sigma2, precision: str = "highest"):
    """``vv (K + σ²I)`` for ``vv`` ``(B, n)``, ``K = kernel(x, x)``, ``x``
    ``(n, d)`` and ``vv`` of one float dtype on one device; ``sigma2`` a
    number or a 0-d tensor.  ``precision``: ``"highest"`` or ``"default"``
    (the bf16-operand contraction).  Values only: no graph."""
    if precision not in ("highest", "default"):
        raise ValueError("precision must be 'highest' or 'default'")
    if x.ndim != 2 or vv.ndim != 2 or vv.shape[1] != x.shape[0]:
        raise ValueError(f"gram_apply: x must be (n, d) and vv (B, n), got {tuple(x.shape)} and {tuple(vv.shape)}")
    if vv.dtype != x.dtype or vv.device != x.device:
        raise TypeError(f"gram_apply: x is {x.dtype} on {x.device}, vv {vv.dtype} on {vv.device}")
    with torch.no_grad():
        if x.device.type == "cpu":
            return gram_apply_ref(kernel, x, vv, sigma2, precision)
        if not fused_route(kernel, x.device.type, x.dtype, x.shape[1]):
            raise ValueError(f"gram_apply: no kernel for {kernel!r} on {x.device}, {x.dtype}, d = {x.shape[1]}")
        return _launch(kernel, x, vv, sigma2, precision == "default")


gram_apply.launches = 0
