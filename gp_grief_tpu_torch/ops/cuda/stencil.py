"""Kernel K5: the SKI ``WᵀW`` stencil apply on the card.

Counterpart of ``gp_grief_tpu.ops.interp_stencil._apply_pallas``; the CUDA
source is ``csrc/wtw_stencil.cu``.  :func:`wtw_stencil` checks its operands
and then

* on CPU tensors runs the plain version
  :func:`~gp_grief_tpu_torch.ops.interp_stencil.stencil_apply_ref`;
* on CUDA tensors launches the kernel on the current stream, or raises.  It
  never falls back to the plain version on the card.

The kernel has two members with the same bits; :func:`stencil_plan`, a rule
on shapes and the card's SM count, picks one: the window member (v's windows
staged in shared memory) where its window fits, else the cell member.  The
wrapper makes a stencil's plan at its first launch at each batch and keeps it
on the stencil (``WtWStencil.plans``).

``wtw_stencil.launches`` counts kernel launches and nothing else.  ``WᵀW`` is
symmetric, so the backward pass is the same stencil on the cotangent, as in
the JAX package's custom VJP.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from gp_grief_tpu_torch.ops.cuda import _build
from gp_grief_tpu_torch.ops.interp_stencil import WtWStencil, stencil_apply_ref

__all__ = ["StencilPlan", "stencil_plan", "wtw_stencil"]

_SYMBOLS = {torch.float32: "gp_grief_wtw_stencil_f32", torch.float64: "gp_grief_wtw_stencil_f64"}

SMEM_LIMIT = 232448  # bytes of shared memory a block can use on sm_90
MAX_ROWS = 16  # rows of v a slab holds in registers (both members)
MAX_GROUPS = 3
# The window member's cells per work item: 1024 at the configurations'
# lattice (32⁴), 128 on small lattices (too few items of 1024 to fill the
# card) and where no 1024-cell window fits.
CELLS = (1024, 128)


class StencilPlan(NamedTuple):
    """How K5 runs one ``(shape, offsets, B, itemsize)``.

    ``member``: ``"window"`` or ``"cell"``.  ``rows``/``slabs``: v's rows per
    slab and the slab count (each slab reads the tables once).  Window member
    only: ``cells`` per work item, ``buffers`` (windows in shared memory: 2
    overlaps the next window's copy with this one's sums), ``pitch`` (a
    window row in shared memory, elements) and ``groups``: ``(begin, end,
    base, width)`` per group, the offsets ``begin:end`` (consecutive in
    ascending order) read from the window ``[c0 + base, c0 + base + width)``
    of an item starting at cell ``c0``.  ``smem_bytes`` is the block's shared
    memory: the windows and one int per offset.
    """

    member: str
    rows: int
    slabs: int
    cells: int = 0
    buffers: int = 0
    pitch: int = 0
    groups: Tuple[Tuple[int, int, int, int], ...] = ()
    smem_bytes: int = 0


def _groups(deltas, d0s):
    """Runs of consecutive offsets (in their ascending order) that share their
    leading-dimension component, as ``[begin, end)`` index ranges."""
    runs = []
    for i, f in enumerate(d0s):
        if runs and d0s[runs[-1][0]] == f:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return [tuple(r) for r in runs]


def stencil_plan(shape: Tuple[int, ...], deltas: Tuple[int, ...], d0s: Tuple[int, ...], B: int,
                 itemsize: int, sms: int = 132) -> StencilPlan:
    """The host rule that picks K5's member and its launch shape.

    * Groups: the runs of ascending offsets with one leading component
      (three at d ≥ 2 where every extent past the first is ≥ 2); summing the
      groups in order sums the offsets in ascending order, as the cell member
      does.  More than three runs: the cell member.  One group spanning all
      offsets replaces them where its window is no longer than theirs together
      (small lattices).
    * Rows: ``slabs = ⌈B / 16⌉``, ``rows = ⌈B / slabs⌉``.
    * Buffers: two if a double window of ``rows`` fits shared memory at some
      ``cells`` in :data:`CELLS`, else one.
    * Cells: the largest that fits and still makes two work items for each
      of the card's ``sms`` SMs (132 on an H100 SXM), else the smallest that
      fits.  Nothing fits (a span of more than ~1700 cells at 16 rows of
      float64): the cell member.

    Each window starts on a 16-byte boundary (``base`` a multiple of
    ``16 // itemsize``) and is a whole number of 16-byte chunks long.
    """
    M = 1
    for n in shape:
        M *= int(n)
    slabs = -(-B // MAX_ROWS)
    rows = -(-B // slabs)
    cell = StencilPlan("cell", MAX_ROWS, slabs)
    runs = _groups(deltas, d0s)
    if len(runs) > MAX_GROUPS:
        return cell
    vec = 16 // itemsize

    def layout(runs, C):
        groups = []
        for b, e in runs:
            base = deltas[b] // vec * vec
            width = -(-(C + deltas[e - 1] - base) // vec) * vec
            groups.append((b, e, base, width))
        return tuple(groups), max(g[3] for g in groups)

    def smem(buffers, pitch):  # the windows, then one int per offset (its place in its window)
        return buffers * rows * pitch * itemsize + 4 * len(deltas)

    def fits(buffers, C):
        return smem(buffers, layout(runs, C)[1]) <= SMEM_LIMIT

    buffers = 2 if any(fits(2, C) for C in CELLS) else 1
    sizes = [C for C in CELLS if fits(buffers, C)]
    if not sizes:
        return cell
    busy = [C for C in sizes if -(-M // C) * slabs >= 2 * sms]
    C = max(busy) if busy else min(sizes)
    groups, pitch = layout(runs, C)
    one, one_pitch = layout([(0, len(deltas))], C)
    if len(runs) > 1 and one_pitch <= sum(g[3] for g in groups) and smem(buffers, one_pitch) <= SMEM_LIMIT:
        groups, pitch = one, one_pitch
    return StencilPlan("window", rows, slabs, C, buffers, pitch, groups, smem(buffers, pitch))


def _c_plan(plan: StencilPlan):
    """The plan as the kernel's int64 array (``csrc/wtw_stencil.cu``: member,
    rows, cells, buffers, pitch, groups, then each group's begin, end, base,
    width)."""
    vals = [int(plan.member == "window"), plan.rows, plan.cells, plan.buffers, plan.pitch, len(plan.groups)]
    for g in plan.groups:
        vals.extend(g)
    return (ctypes.c_longlong * len(vals))(*vals)


def _cached_plan(st: WtWStencil, B: int, itemsize: int):
    """The plan K5 runs for ``st`` at ``(B, itemsize)`` on the card that holds
    its tables, and the plan's C array: made at the first launch, then read
    from ``st.plans``."""
    hit = st.plans.get((B, itemsize))
    if hit is None:
        sms = torch.cuda.get_device_properties(st.tables.device).multi_processor_count
        plan = stencil_plan(st.shape, st.deltas, st.d0s, B, itemsize, sms=sms)
        hit = st.plans[(B, itemsize)] = (plan, _c_plan(plan))
    return hit


def _launch(st: WtWStencil, v: torch.Tensor, plan: StencilPlan | None = None) -> torch.Tensor:
    if v.dtype not in _SYMBOLS:
        raise TypeError(f"wtw_stencil kernel takes float32 or float64, got {v.dtype}")
    if st.tables.dtype != v.dtype:
        raise TypeError(f"wtw_stencil: tables are {st.tables.dtype}, v is {v.dtype}")
    if not (v.is_contiguous() and st.tables.is_contiguous()):
        raise ValueError("wtw_stencil kernel needs contiguous v and tables")
    B, M = int(v.shape[0]), st.M
    out = torch.empty((B, M), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    itemsize = v.element_size()
    plan, c_plan = _cached_plan(st, B, itemsize) if plan is None else (plan, _c_plan(plan))
    # 16-byte copies of v's windows where its rows start on 16-byte boundaries.
    copy = 16 if v.data_ptr() % 16 == 0 and M % (16 // itemsize) == 0 else itemsize
    # The library is loaded once (ctypes keeps each symbol after its first
    # lookup); the device's raw stream handle, with no device context or
    # Stream object per call.
    fn = getattr(_build.load_library(), _SYMBOLS[v.dtype])
    device = v.device.index
    err = fn(v.data_ptr(), st.tables.data_ptr(), st.delta_t.data_ptr(), len(st.deltas), out.data_ptr(), B, M,
             c_plan, copy, device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"wtw_stencil kernel launch failed with cudaError {err} at (B, M, D) = "
                           f"{(B, M, len(st.deltas))}, {plan.member} member")
    wtw_stencil.launches += 1
    return out


def _apply(st: WtWStencil, v: torch.Tensor) -> torch.Tensor:
    if v.device.type == "cuda":
        return _launch(st, v)
    if v.device.type == "cpu":
        return stencil_apply_ref(st, v)
    raise ValueError(f"wtw_stencil: no kernel for device {v.device}")


class _WtW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st, v):
        ctx.st = st
        return _apply(st, v)

    @staticmethod
    def backward(ctx, g):
        return None, _apply(ctx.st, g.contiguous())


def wtw_stencil(st: WtWStencil, v_bm: torch.Tensor) -> torch.Tensor:
    """``WᵀW v`` for batch-major lattice vectors ``v_bm`` ``(B, M)``.
    Differentiable in ``v_bm``."""
    if v_bm.ndim != 2 or int(v_bm.shape[1]) != st.M:
        raise ValueError(f"wtw_stencil: v must be (B, {st.M}), got {tuple(v_bm.shape)}")
    if st.tables.device != v_bm.device:
        raise ValueError(f"wtw_stencil: tables on {st.tables.device}, v on {v_bm.device}")
    if torch.is_grad_enabled() and v_bm.requires_grad:
        return _WtW.apply(st, v_bm)
    return _apply(st, v_bm)  # a solver's apply: no graph to build


wtw_stencil.launches = 0
