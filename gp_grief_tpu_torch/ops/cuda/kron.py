"""Kernels K2 and K3: the Kronecker matvec ``(⊗_d K_d) · V`` on the card.

Counterparts of ``gp_grief_tpu.ops.pallas.kron_pallas.kron_matvec_slab``
(K2: square factors, d ≥ 3) and ``kron_matvec_fused`` (K3: ragged,
rectangular, d = 2, leading-identity batches).  On Hopper both run the same
kernel family, ``csrc/kron_pass.cu``: each launch contracts a group of up to
three adjacent lattice axes in one read and one write of device memory, and
the pass plan (:func:`_hopper_plan`) takes as few passes as shared memory
allows.  The two wrappers differ in what they accept, in ``mid_dtype`` (the
slab may store the vector between passes as bf16) and in their launch
counters.

Each wrapper checks its operands and then

* on CPU tensors runs the plain version :func:`kron_chain_ref`;
* on CUDA tensors launches the kernels on the current stream, or raises.  It
  never falls back to the plain version on the card.

``kron_matvec_slab.launches`` / ``kron_matvec_fused.launches`` count kernel
launches (one per pass) and nothing else; ``exact_tile_launches`` counts
those of them that ran on the exact grade's tile member.  The backward pass
is the vector-Jacobian product of the exact plain chain, as in the JAX
package's custom VJPs: the TPU kernels had no backward kernel either.

Grades (``precision``): ``"highest"`` is float32-accurate: its tile passes
run the exact member, its wide passes 3xTF32 tensor-core products (which
round differently from the plain chain's).  The exact member lands the
tile's rows through a two-stage ``cp.async`` ring, contracts the innermost
axis as the rows leave the ring, a middle axis in place and the outermost on
its way to device memory, each output one FMA chain over k in order, four
fibres by eight outputs a thread; :func:`_exact_tile_plan` picks its columns
and rows of ``pre`` and :func:`_exact_tile_layout` restates its shared
memory.  Its floors at 32 points: 96 FMAs an element for a 3-axis pass
(0.10 ms of FP32 at 32⁵ beside 0.08 ms of bytes), 64 for a 2-axis one; on
an H100 it runs at 2-3.4× the byte bound, its FMA loop issuing on about
half the cycles (PERF.md §6).  ``"default"``
rounds every operand of every contraction to bf16 and accumulates in f32,
its tile passes on the tensor-core tile member (bf16 ``mma.sync``) wherever
that member takes the group (:func:`_mma_tile_ok`), else on the FP32 tile
member.  A bf16 input vector forces ``"default"`` and gives a bf16 result.

A leading batch identity made by :func:`batch_identity` (the solvers' ``(I_B,
*factors)`` call form) is never contracted as a matrix: the wrappers fold it
into the plan's ``lead`` rows (:func:`split_lead`), on the card and in the
plain version alike.  :func:`plan_takes` says whether every pass of the
plan is within what its member takes; :func:`kernel_for` names the wrapper
that takes a product (K2: square factors, d ≥ 3, every axis on the tile
members; K3: the rest).

:func:`slab_schedule_applicable`, :func:`fused_schedule_applicable` and
:func:`_fused_schedule` are copied from ``kron_pallas.py`` unchanged, as the
record of where the JAX package sends a product on a TPU.  Their lane and
VMEM arithmetic describes the TPU kernels, not these, and they decide no
route of the port: ``ops.kron_fast.kernel_route`` routes by the Hopper plan
and this card's measurements, and the tests hold it to send every product
these gates send to a Pallas kernel to K2/K3.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

from gp_grief_tpu_torch.ops.cuda._build import load_library

__all__ = [
    "batch_identity",
    "kernel_for",
    "plan_takes",
    "split_lead",
    "tile_only",
    "kron_chain_ref",
    "kron_matvec_slab",
    "kron_matvec_fused",
    "slab_schedule_applicable",
    "fused_schedule_applicable",
]

# ---------------------------------------------------------------------------
# Routing gates, copied from gp_grief_tpu/ops/pallas/kron_pallas.py
# (:88-97, :286-294, :633-700, :750-782, :841-965, :1067-1091).
# ---------------------------------------------------------------------------

_FUSED_VMEM_BUDGET = 36 * 1024 * 1024
_FUSED_MAX_GROUP = 3  # block rank cap: (lead, a, b, c[, BL]) — Mosaic-tested


def _pad128(x: int) -> int:
    """Lane padding: Mosaic pads the last dim to a multiple of 128."""
    return -(-x // 128) * 128


def _padded_bytes(shape, itemsize) -> int:
    """VMEM footprint of a block: lane (last) dim pads to 128, sublane
    (second-to-last) to 8."""
    if len(shape) == 0:
        return itemsize
    s = list(shape)
    s[-1] = _pad128(s[-1])
    if len(s) >= 2:
        s[-2] = -(-s[-2] // 8) * 8
    return math.prod(s) * itemsize


def _tail_group_bytes(BB, ms, outs, itemsize) -> int:
    """Peak VMEM of a tail-group block chain: in+out double-buffered (4x)
    + the worst intermediate + operands (×2.5: Mosaic HIGHEST's x6
    emulation materializes hi/lo bf16 operand copies — a 2048² factor
    measured 72.9M scoped against a 64M limit with a 1× allowance)."""
    g = len(ms)
    peak_tmp = 0
    for k in range(1, g):
        shape = (BB, *ms[k:], *outs[:k])
        peak_tmp = max(peak_tmp, _padded_bytes(shape, 4))  # f32 accum
    io = 2 * (_padded_bytes((BB, *ms), itemsize) + _padded_bytes((BB, *outs), itemsize))
    ops = sum(_padded_bytes((o, m), itemsize) for o, m in zip(outs, ms))
    return io + 2 * peak_tmp + (5 * ops) // 2


def _pick_lane_block(L: int, bound: int) -> int:
    """Largest legal Mosaic lane-block: a divisor of ``L`` that is a
    multiple of 128 (the Pallas TPU block constraint) and ≤ ``bound``, or
    ``L`` itself (a full-extent block is always legal) when it fits.
    Returns 0 if no legal block exists."""
    best = L if L <= bound else 0
    if L % 128 == 0:
        k = L // 128
        b = min(k, bound // 128)
        while b >= 1:
            if k % b == 0:
                best = max(best, 128 * b)
                break
            b -= 1
    return best


def _mid_group_BL(ms, outs, itemsize, pre, L) -> int:
    """Legal lane-block size for a mid-group pass (0 = infeasible).
    Shared by the pass and by :func:`_fused_schedule` so the plan never
    commits to a pass the kernel cannot tile."""
    g = len(ms)
    # Peak per-lane-column bytes across the chain: after k right-to-left
    # contractions the block is (o_{g-k+1..g}, m_{1..g-k}, BL).
    col_peak = max(
        math.prod(outs[g - k :]) * math.prod(ms[: g - k]) * 4
        for k in range(g + 1)
    )
    col_io = (math.prod(ms) + math.prod(outs)) * itemsize
    # Operand allowance ×2.5: Mosaic HIGHEST x6 materializes hi/lo bf16
    # copies of the weights (see _tail_group_bytes).
    budget = _FUSED_VMEM_BUDGET - (
        5 * sum(_padded_bytes((o, m), itemsize) for o, m in zip(outs, ms))
    ) // 2
    if budget <= 0:
        return 0
    bound = max(128, budget // (2 * col_io + 2 * col_peak))
    # Pipelining: keep the grid ≥ 8 blocks when pre is small — a 1-block
    # grid leaves the DMA/compute pipeline empty (measured r14).
    capped = bound
    if pre < 8 and L >= 8 * 128:
        capped = min(bound, max(128, L // 8))
    BL = _pick_lane_block(L, min(L, capped))
    if BL == 0 and capped < bound:
        # The pipelining PREFERENCE must not turn a feasible plan infeasible:
        # when L has no 128-divisible divisor under the cap, fall back to
        # the full VMEM bound (e.g. L=10⁴ at 100³ — only the full-extent
        # block is Mosaic-legal).
        BL = _pick_lane_block(L, min(L, bound))
    return BL


def _fused_schedule(ms: Sequence[int], outs: Sequence[int], B: int, itemsize: int):
    """Greedy pass plan for :func:`kron_matvec_fused`.

    Returns ``(mid_groups, tail_start)``: ``mid_groups`` is a list of
    ``(i, j)`` inclusive factor ranges contracted as mid-group passes (in
    order), and factors ``tail_start..d-1`` (+ an I_B when batched) form one
    tail-group pass.  ``None`` if no feasible plan exists."""
    d = len(ms)
    budget = _FUSED_VMEM_BUDGET

    # Lane-pad economics (measured, exp_r14_general.py round 1): every block
    # DMA moves LANE-PADDED bytes, so the trailing axis of any tail block
    # must be ≥ 96 (pad waste ≤ 1.33×).  A trailing batch axis of small B is
    # catastrophic (B=8 → 16× padded traffic: the fused path lost 5.7× to
    # the cyclic chain) — solvers avoid it by folding batches as a LEADING
    # identity factor (B-major; the (eyeB, *factors) convention), which this
    # scheduler handles as an ordinary cheap mid factor.
    if B > 1 and B < 96:
        return None
    if B == 1 and (ms[-1] < 96 or outs[-1] < 96):
        return None

    # Largest tail group feasible by VMEM at BB=1 (including the I_B factor
    # appended for batched inputs so the axis order self-restores).  A tail
    # that swallows (almost) the whole lattice leaves a 1-block grid with no
    # DMA/compute pipelining — measured 133 µs single-block vs ~68 µs
    # pipelined at the 885k eyeB8 shape — so a big tail block is only
    # accepted when ≥ 8 grid blocks remain in front of it (or the block is
    # small enough that pipelining cannot matter).
    tail_start = d
    for t in range(d - 1, -1, -1):
        tms = list(ms[t:]) + ([B] if B > 1 else [])
        touts = list(outs[t:]) + ([B] if B > 1 else [])
        if len(tms) > _FUSED_MAX_GROUP + 1:
            break
        if _tail_group_bytes(1, tms, touts, itemsize) > budget:
            break
        n_lead = math.prod(outs[:t]) if t else 1  # grid extent at execution
        blk = _padded_bytes((1, *tms), itemsize)
        if n_lead < 8 and blk > (1 << 20):
            break
        tail_start = t
    if tail_start == d:
        # Need at least the last factor in the tail (a mid pass for the
        # final factor would have no trailing lane extent).
        return None

    # Mid groups over 0..tail_start-1, greedy left-to-right.
    mid_groups = []
    i = 0
    while i < tail_start:
        j = i
        while (
            j + 1 < tail_start
            and j - i + 1 < _FUSED_MAX_GROUP
            and math.prod(ms[i : j + 2]) * 128 * itemsize * 6 < budget
        ):
            j += 1
        # Trailing lane extent of this pass: ≥ 96 actual lanes (see above),
        # and a legal Mosaic lane block must exist (divisor of L that is a
        # multiple of 128, or a full-extent block within VMEM).  ``pre`` is
        # the product of the ALREADY-CONTRACTED factors' OUTPUT sizes —
        # exactly what _mid_group_pass will see at execution (rectangular
        # factors differ from prod(ms[:i])).
        L = math.prod(ms[j + 1 :]) * B
        pre = math.prod(outs[:i])
        while (
            L < 96
            or _mid_group_BL(ms[i : j + 1], outs[i : j + 1], itemsize, pre, L) == 0
        ):
            if j == i:
                return None
            j -= 1  # shrink the group; a smaller block may tile legally
            L = math.prod(ms[j + 1 :]) * B
        mid_groups.append((i, j))
        i = j + 1
    return mid_groups, tail_start


def fused_schedule_applicable(
    factors: Sequence[torch.Tensor],
    B: int = 1,
    *,
    fast: bool = False,
    feasible_only: bool = False,
) -> bool:
    """True when :func:`kron_matvec_fused` has a feasible plan AND the shape
    class is one where it beats the cyclic XLA chain — the general-shape
    (ragged / d=2 / wide-pair) companion to :func:`slab_schedule_applicable`
    (round-3 next-step #1).

    EXACT-grade win class (re-measured round-5 on chip — the r14 "whole
    lattice in one pass" class did NOT reproduce at B=1: 24×48×96 0.75×,
    (256, 96) 0.45×, bare 512²/1024² 1.0–1.14×): the fused path wins only
    on LARGE work with a wide factor — a ≥512-wide factor AND ≥2^21 total
    elements (the batched solver forms: (I₈, 512²) 3.51×, (I₁₆, 512²)
    2.18×, (I₈, 1024²) 2.86× — benchmarks/exp_r15 probes).  Everything
    else stays on the cyclic chain at exact grade (losses measured down to
    0.45×; ``impl="fused"`` still forces).

    At ``fast=True`` (the DEFAULT bf16 operating point: ONE bf16 dot per
    contraction instead of x6 emulation) the win class widens to any
    feasible shape with a factor ≥ 100 (100³ 58.5→17.2 µs = 3.4×;
    (I₈, 512²) 599→41 µs = 14×); only the sub-100 ragged multi-factor class
    ((I₈, 24·48·96): 0.9–1.8× across runs, inside run-to-run noise) stays
    on the chain."""
    ms, outs = [], []
    for K in factors:
        if K.ndim != 2:
            return False
        outs.append(int(K.shape[0]))
        ms.append(int(K.shape[1]))
    if not ms or math.prod(ms) * B < (1 << 12):
        return False  # tiny: XLA dispatch wins, nothing to gain
    plan = _fused_schedule(ms, outs, B, int(factors[0].dtype.itemsize))
    if plan is None:
        return False
    if feasible_only:
        # ``impl="fused"`` forcing / experiments: any feasible plan runs —
        # the win-class heuristics below gate only the AUTO dispatch.
        return True
    _, tail_start = plan
    if fast:
        return tail_start == 0 or max(ms) >= 100
    return max(ms) >= 512 and math.prod(ms) * max(B, 1) >= (1 << 21)


def slab_schedule_applicable(factors: Sequence[torch.Tensor], B: int = 1) -> bool:
    """True when the 3-pass rotation-free schedule handles these shapes
    efficiently: square factors, d >= 3, every leading factor dividing 128,
    the trailing pair (x batch) between 128 and 2048 lanes wide, and a
    lattice large enough to be bandwidth-bound."""
    ms = []
    for K in factors:
        if K.ndim != 2 or K.shape[0] != K.shape[1]:
            return False
        ms.append(int(K.shape[0]))
    if len(ms) < 3:
        return False
    m_total = math.prod(ms) * B
    S = ms[-2] * ms[-1] * B  # trailing pair chunk (lane width of the pair dot)
    if not (128 <= S <= 2048):
        return False
    post = m_total
    for m in ms[:-2]:
        if m < 2 or 128 % m:
            return False
        post //= m
        G = 128 // m
        if post % G or (post // G) % 128:
            return False
    return m_total >= (1 << 18)


# ---------------------------------------------------------------------------
# The Hopper pass plan and the plain version.
# ---------------------------------------------------------------------------

_ERR_SHAPE = -1  # csrc: the return value for arguments a member does not take
_TILE_MAX_AXIS = 64  # fibre registers a thread holds (csrc: MAXN <= 64)
_TILE_MAX_GROUP = 3
_SMEM_LIMIT = 232448  # bytes of shared memory a block can use on sm_90
_TILE_MAX_P = 128
_TILE_MAX_OUT = 8 * 32  # csrc EX_OUT x 32: an exact-member task holds 8 of a factor's rows, 32 tasks a warp
_COALESCED_P = 32  # 128-byte rows of f32: the least run worth a global load
# csrc TWO_BLOCK_SMEM: a tile block of at most this many bytes leaves room
# for a second resident block on an SM (228 KB shared by the blocks, 1 KB
# reserved for each) and runs 256 threads, each taking two fibres at a time.
_TWO_BLOCK_SMEM = 233472 // 2 - 1024
_TILE_FIBRES = 2 * 256
_TILE_MIN_BATCHES = 2 * 132  # two resident blocks on each of an H100's SMs
_WIDE_TILE_N = (64, 128)  # csrc: output-tile widths of the wide member
# The tensor-core tile member (fast grade; csrc kron_mma_tile_kernel) runs
# two blocks an SM (its registers), each of 8 warps.
_MMA_MIN_TASKS = 2 * 8  # two warp tasks for each of a block's 8 warps


def _tile_smem_bytes(ns, outs, P: int, R: int = 1) -> int:
    """Shared memory of one tile-pass block staging ``R`` rows of ``pre``;
    the same arithmetic as ``gp_grief_kron_tile_pass`` in
    csrc/kron_pass.cu."""
    ext = [max(n, o) for n, o in zip(ns, outs)] + ([P] if P > 1 else [])
    ext[-1] |= 1  # odd innermost extent: fibres along it fall in distinct banks
    tile = R * math.prod(ext)
    floats = -(-tile // 4) * 4 + sum(o * (-(-n // 4) * 4) for n, o in zip(ns, outs))
    return 4 * floats


def _tile_rows(ns, outs, P: int, post: int, pre: int) -> int:
    """Rows of ``pre`` a tile-pass block stages at once.  Only a pass whose
    ``P`` columns cover the whole trailing extent batches rows (``R``
    consecutive rows are then one contiguous run).  ``R`` doubles until every
    contraction of the group has ``_TILE_FIBRES`` fibres (two for each of a
    block's 256 threads), as long as the tile still leaves room for a second
    resident block and ``pre`` still gives every resident block a batch."""
    if P != post:
        return 1

    def fibres(R):  # the fewest fibres of any of the group's contractions, last axis first
        return R * P * min(math.prod(ns[:t]) * math.prod(outs[t + 1 :]) for t in range(len(ns)))

    R = 1
    while (fibres(R) < _TILE_FIBRES and pre >= 2 * R * _TILE_MIN_BATCHES
           and _tile_smem_bytes(ns, outs, P, 2 * R) <= _TWO_BLOCK_SMEM):
        R *= 2
    return R


def _wide_tile(o: int, post: int) -> int:
    """Output-tile width of a wide pass: 64 when the output's width is at
    most 64 (``o`` when the axis is last, else ``post``), so that no half of
    a tile computes zeros; else 128.  (The C side narrows exact-grade passes
    deeper than its ``FLUSH_DEPTH`` to 64 whatever it is given: their
    per-chunk partial sums double the accumulators.)"""
    width = o if post == 1 else post
    return _WIDE_TILE_N[0] if width <= _WIDE_TILE_N[0] else _WIDE_TILE_N[1]


def _pow2_16(v: int) -> int:
    """The next power of two of at least ``max(v, 16)``: the mma member's
    padded extents (m16/k16 fragments; shifts, not divisions, for indices)."""
    return max(16, 1 << (max(v, 1) - 1).bit_length())


def _mma_tile_smem_bytes(ns, outs, P: int, R: int = 1) -> int:
    """Shared memory of one block of the tensor-core tile member: ``R`` rows
    of the bf16 tile, every axis padded to ``E = _pow2_16(max(n, o))`` and
    the columns to ``_pow2_16(P)``, then each factor as an ``E × E`` bf16
    block; the same arithmetic as ``gp_grief_kron_tile_pass`` (``mma``) in
    csrc/kron_pass.cu."""
    E = [_pow2_16(max(n, o)) for n, o in zip(ns, outs)]
    row = math.prod(E) * (_pow2_16(P) if P > 1 else 1)
    return 2 * (R * row + sum(e * e for e in E))


def _mma_tile_ok(ns, outs, P: int) -> bool:
    """Whether the tensor-core member takes a tile pass: every extent at most
    64, at most 128 columns, not a lone innermost axis (``g == 1``, ``P ==
    1``: its rows would be the m16 dimension), and one row's tile in
    shared memory."""
    return (max(*ns, *outs) <= _TILE_MAX_AXIS and P <= _TILE_MAX_P and not (len(ns) == 1 and P == 1)
            and _mma_tile_smem_bytes(ns, outs, P) <= _SMEM_LIMIT)


def _mma_tile_rows(ns, outs, P: int, post: int, pre: int) -> int:
    """Rows of ``pre`` a tensor-core tile block stages (only where the ``P``
    columns cover the trailing extent, as in :func:`_tile_rows`): ``R``
    doubles while some contraction of the group has fewer than
    ``_MMA_MIN_TASKS`` warp tasks, the tile leaves room for a second
    resident block, and ``pre`` gives every one of two blocks an SM a
    batch."""
    if P != post:
        return 1
    E = [_pow2_16(max(n, o)) for n, o in zip(ns, outs)]
    Pp = _pow2_16(P) if P > 1 else 1

    def tasks(R):  # the fewest warp tasks of any of the group's contractions
        out = []
        for t in range(len(E)):
            A, C = R * math.prod(E[:t]), math.prod(E[t + 1 :]) * Pp
            if C == 1:  # X·Kᵀ: 64 rows a task (16 · 64 / E)
                out.append(A * E[t] // 1024)
            else:  # K·X_a: 1024 / E columns a task
                out.append(A * max(1, C * E[t] // 1024))
        return min(out)

    R = 1
    while (tasks(R) < _MMA_MIN_TASKS and pre >= 2 * R * _TILE_MIN_BATCHES
           and _mma_tile_smem_bytes(ns, outs, P, 2 * R) <= _TWO_BLOCK_SMEM):
        R *= 2
    return R


# The exact grade's tile member (csrc kron_exact_tile_kernel): 256 threads,
# each task four fibres x an 8-output slice of a factor.
_EXACT_THREADS = 256
_EXACT_OUT = 8
_EXACT_MIN_TILES = 2 * 132  # at least two tiles for each of an H100's SMs, where pre allows
_EXACT_COLUMNS = 32  # 128-byte runs of f32


def _slices(o: int) -> int:
    """8-output slices of a factor with ``o`` rows, a power of two (the
    lanes that share a fibre group are neighbours in one warp)."""
    return 1 << max(0, (-(-o // _EXACT_OUT) - 1).bit_length())


def _exact_rows(nlast: int, olast: int, P: int, post: int) -> tuple[int, int]:
    """``(ls, inner)`` of the exact member: the floats between landed rows
    (``P`` rounded up to 4 with columns; ``n_last`` rounded up to an odd
    number of float4s without, so that four-row reads fall in distinct
    banks), and T's floats a unit (``o_last`` rounded up to 4 without
    columns; ``o_last × ls`` with them, or, where ``P`` is not a multiple of
    4, the ``o_last × P`` outputs packed and rounded up to 4)."""
    if post == 1:
        return 4 * ((-(-nlast // 4)) | 1), -(-olast // 4) * 4
    ls = 4 * -(-P // 4)
    return ls, olast * ls if P % 4 == 0 else -(-(olast * P) // 4) * 4


def _exact_tile_layout(ns, outs, P: int, R: int, post: int) -> tuple[int, int]:
    """``(shared-memory bytes, units a chunk)`` of the exact member's block
    for a tile pass: the transposed factors (``n × 8·slices``), T (the tile
    after its innermost contraction, ``R × E_0 [× E_1] × inner``, ``E =
    max(n, o)``) and two ring stages of landed rows (:func:`_exact_rows`).
    A unit is one device-memory row of the innermost axis (``post == 1``) or
    its ``n_last × P`` block; a chunk takes enough units for a task per
    thread, at most a tile's, halved until the block fits.  The same
    arithmetic as ``exact_layout`` in csrc/kron_pass.cu; bytes past
    ``_SMEM_LIMIT`` mean the member does not take the pass."""
    g = len(ns)
    rows = post == 1
    kfl = sum(n * _EXACT_OUT * _slices(o) for n, o in zip(ns, outs))
    rpu = 1 if rows else ns[-1]
    ls, inner = _exact_rows(ns[-1], outs[-1], P, post)
    E = [max(n, o) for n, o in zip(ns, outs)]
    tfl = 0 if g == 1 else R * math.prod(E[:-1]) * inner
    units = R * math.prod(ns[:-1])
    S = _slices(outs[-1])

    def tasks(cu):
        return (-(-cu // 4) if rows else cu * (ls // 4)) * S

    def stage(cu):
        return (-(-cu // 4) * 4 if rows else cu) * rpu * ls

    if g == 1:
        cu = R
    else:
        cu = 1
        while cu < units and tasks(cu) < _EXACT_THREADS:
            cu *= 2
        cu = min(cu, units)
        while cu > 1 and 4 * (kfl + tfl + 2 * stage(cu)) > _SMEM_LIMIT:
            cu //= 2
    return 4 * (kfl + tfl + 2 * stage(cu)), cu


def _exact_tile_plan(ns, outs, post: int, pre: int) -> tuple[int, int] | None:
    """``(P, R)`` of an exact-grade tile pass, or None where the member does
    not take it.  Columns: ``_EXACT_COLUMNS`` (g ≥ 2: T holds the whole
    group's extent times P), or at g = 1 enough for a task per thread in one
    unit; halved until the block fits.  Rows of ``pre`` (only where P covers
    ``post``) double while the outer contraction (g ≥ 2), or the one (g = 1),
    has fewer tasks than threads, the block fits, and ``pre`` keeps
    ``_EXACT_MIN_TILES`` tiles."""
    g = len(ns)
    if max(ns) > _TILE_MAX_AXIS or max(outs) > _TILE_MAX_OUT:
        return None
    if post == 1:
        P = 1
    elif g == 1:
        P = min(post, max(_EXACT_COLUMNS, 4 * _EXACT_THREADS // _slices(outs[0])))
    else:
        P = min(post, _EXACT_COLUMNS)
    while P > 1 and _exact_tile_layout(ns, outs, P, 1, post)[0] > _SMEM_LIMIT:
        P //= 2
    if _exact_tile_layout(ns, outs, P, 1, post)[0] > _SMEM_LIMIT:
        return None
    ls, inner = _exact_rows(ns[-1], outs[-1], P, post)
    outer = 1 if g == 1 else (max(ns[1], outs[1]) if g == 3 else 1) * inner // 4

    def tasks(R):  # the outer contraction's (g >= 2), or the only one's (g == 1)
        if g == 1:
            return (-(-R // 4) if post == 1 else R * (ls // 4)) * _slices(outs[0])
        return R * outer * _slices(outs[0])

    R = 1
    if P == post:
        while (tasks(R) < _EXACT_THREADS and pre >= 2 * R * _EXACT_MIN_TILES
               and _exact_tile_layout(ns, outs, P, 2 * R, post)[0] <= _SMEM_LIMIT):
            R *= 2
    return P, R


def _tile_columns(ns, outs, post: int) -> int:
    """Trailing columns per block for a tile pass: ``min(post, 128)``, halved
    until the tile fits shared memory but not below ``min(post, 32)`` (rows
    of 128 bytes keep global loads coalesced); 0 when that does not fit."""
    P = min(post, _TILE_MAX_P)
    floor = min(post, _COALESCED_P)
    while P > floor and _tile_smem_bytes(ns, outs, P) > _SMEM_LIMIT:
        P = max(floor, P // 2)
    return P if _tile_smem_bytes(ns, outs, P) <= _SMEM_LIMIT else 0


def _hopper_plan(ms: Sequence[int], outs: Sequence[int], B: int):
    """Passes for ``(⊗ K_d) · V`` on Hopper, contracting from the last axis
    to the first: a list of ``(i, j, P)``, each one launch over factors
    ``i..j``.  ``P = 0`` marks a wide pass (one axis of more than 64 points
    or more than 256 outputs, a GEMM); otherwise a tile pass of up to three
    axes with ``P`` trailing columns per block (the fast grade's FP32
    member's; the exact member plans its own).  A group grows leftwards
    while the FP32 member's tile fits shared memory with coalesced loads and
    the exact member has a plan for it."""
    d = len(ms)
    passes = []
    j = d - 1
    while j >= 0:
        post = math.prod(outs[j + 1 :]) * B
        best = None
        i = j
        while i >= 0 and j - i < _TILE_MAX_GROUP and ms[i] <= _TILE_MAX_AXIS:
            P = _tile_columns(ms[i : j + 1], outs[i : j + 1], post)
            if P == 0 or _exact_tile_plan(ms[i : j + 1], outs[i : j + 1], post, 1) is None:
                break
            best = (i, P)
            i -= 1
        if best is None:
            passes.append((j, j, 0))
            j -= 1
        else:
            passes.append((best[0], j, best[1]))
            j = best[0] - 1
    return passes


# The attribute that marks a tensor made by batch_identity.
_LEAD_MARK = "kron_batch_identity"


def batch_identity(n: int, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """``torch.eye(n)`` marked as the leading batch identity of ``(I_n ⊗ (⊗
    K_d))``, the solvers' ``(I_B, *factors)`` call form.  K2 and K3 fold it
    into their plan's ``lead`` rows and never contract it as a matrix; every
    other consumer (the chain, the copied gates) sees the identity matrix it
    is.  The mark is an attribute of this tensor, so nothing reads its values
    to recognise it; a copy (``.to``, ``.clone``) is an ordinary matrix."""
    eye = torch.eye(n, dtype=dtype, device=device)
    setattr(eye, _LEAD_MARK, True)
    return eye


def split_lead(factors: Sequence[torch.Tensor]) -> tuple[int, tuple]:
    """``(lead, core)``: the size of a leading :func:`batch_identity` and the
    factors after it, or ``(1, factors)`` where there is none."""
    if len(factors) > 1 and getattr(factors[0], _LEAD_MARK, False):
        return int(factors[0].shape[0]), tuple(factors[1:])
    return 1, tuple(factors)


_INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=512)
def _plan_takes(ms: tuple, outs: tuple, B: int, lead: int, fast: bool) -> bool:
    for _, _, _, wide, args in _passes(ms, outs, B, lead, None, fast):
        if wide:  # csrc gp_grief_kron_wide_pass: C = X·Kᵀ (post = 1) takes pre rows, C_p = K·X_p post columns
            n, o, pre, post, _ = args
            if max(n, o, pre if post == 1 else post) > _INT32_MAX:
                return False
        else:  # gp_grief_kron_tile_pass: every axis at most 64 points; the members' shared memory
            g, n, o, (pre, post, P, R, mma) = args[0], args[1:4], args[4:7], args[7:]
            ns, os_ = n[:g], o[:g]
            if max(ns) > _TILE_MAX_AXIS or P < 1 or P > post or R < 1:
                return False
            if mma:
                ok = _mma_tile_ok(ns, os_, P) and _mma_tile_smem_bytes(ns, os_, P, R) <= _SMEM_LIMIT
            elif fast:
                ok = _tile_smem_bytes(ns, os_, P, R) <= _SMEM_LIMIT
            else:
                ok = max(os_) <= _TILE_MAX_OUT and _exact_tile_layout(ns, os_, P, R, post)[0] <= _SMEM_LIMIT
            if not ok:
                return False
    return True


def plan_takes(factors: Sequence[torch.Tensor], B: int = 1, *, fast: bool = False) -> bool:
    """Whether K2/K3 take ``(⊗ K_d) · V`` (``V`` with ``B`` columns) at a
    grade: matrices, and every pass of the Hopper plan (:func:`_hopper_plan`,
    a leading :func:`batch_identity` folded into ``lead``) within the limits
    of ``gp_grief_kron_tile_pass`` / ``gp_grief_kron_wide_pass``
    (csrc/kron_pass.cu).  Cached by shape."""
    lead, core = split_lead(factors)
    if not core or any(K.ndim != 2 for K in core):
        return False
    ms = tuple(int(K.shape[1]) for K in core)
    outs = tuple(int(K.shape[0]) for K in core)
    return min(*ms, *outs, B, lead) >= 1 and _plan_takes(ms, outs, int(B), lead, bool(fast))


@functools.lru_cache(maxsize=512)
def tile_only(ms: tuple, outs: tuple, B: int) -> bool:
    """Whether every pass of the Hopper plan of factors ``(o_d, m_d)`` is a
    tile pass (every axis on the tile members, none on the wide one)."""
    return all(P > 0 for *_, P in _hopper_plan(ms, outs, B))


def kernel_for(factors: Sequence[torch.Tensor], B: int = 1) -> str:
    """The wrapper that takes a product: ``"slab"`` (K2) for square factors,
    d ≥ 3 and a plan of tile passes only (a leading :func:`batch_identity`
    folded), else ``"fused"`` (K3)."""
    _, core = split_lead(factors)
    ms = tuple(int(K.shape[1]) for K in core)
    outs = tuple(int(K.shape[0]) for K in core)
    return "slab" if len(ms) >= 3 and ms == outs and tile_only(ms, outs, int(B)) else "fused"


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def kron_chain_ref(factors: Sequence[torch.Tensor], v: torch.Tensor, *, fast: bool = False) -> torch.Tensor:
    """Plain version of K2, K3, K7 and K8: ``(⊗ K_d) · v`` for ``v``
    ``(M, B)``, one ``tensordot`` per axis from the last to the first, as
    the kernels' passes run.  ``fast`` rounds both operands of
    every contraction to bf16 (products accumulate in the working precision),
    which also stands for the kernels' bf16 storage between passes.  Computes
    in float64 for a float64 ``v``, else float32; returns ``v``'s dtype.

    A leading :func:`batch_identity` is folded into the rows, as the kernels
    fold it: at the exact grade the result is the unfolded chain's, bit for
    bit (an identity contraction adds exact zeros); at ``fast`` it skips that
    contraction's bf16 rounding of its input."""
    return _chain_ref(*split_lead(factors), v, fast)


def _chain_ref(lead: int, factors, v: torch.Tensor, fast: bool) -> torch.Tensor:
    """:func:`kron_chain_ref` of ``(I_lead ⊗ (⊗ K_d))``, ``v`` ``(lead·M, B)``."""
    work = torch.float64 if v.dtype == torch.float64 else torch.float32
    ms = [int(K.shape[1]) for K in factors]
    cur = list(ms)
    B = int(v.shape[1])
    x = v.to(work)
    for t in reversed(range(len(factors))):
        K = factors[t].to(work)
        if fast:
            K, x = _bf16_round(K), _bf16_round(x)
        pre, post = lead * math.prod(cur[:t]), math.prod(cur[t + 1 :]) * B
        x = torch.einsum("ok,pkq->poq", K, x.reshape(pre, cur[t], post))
        cur[t] = int(K.shape[0])
    return x.reshape(-1, B).to(v.dtype)


@functools.lru_cache(maxsize=512)
def _passes(ms: tuple, outs: tuple, B: int, lead: int, plan: tuple | None, fast: bool = False) -> tuple:
    """The launches of a pass plan (``plan`` defaults to
    :func:`_hopper_plan`) at a grade, as ``(i, j, out_shape, wide, args)``:
    ``args`` are the shape arguments of ``gp_grief_kron_wide_pass`` (``n,
    o, pre, post, tile width``) or ``gp_grief_kron_tile_pass`` (``g,
    n0..n2, o0..o2, pre, post, P, R, mma``).  At the fast grade a tile pass
    the tensor-core member takes (:func:`_mma_tile_ok`) runs there with its
    own rows (``mma = 1``); every other fast-grade tile pass runs the FP32
    member.  An exact-grade tile pass runs the exact member, its ``P`` and
    ``R`` from :func:`_exact_tile_plan`.  Cached: the wrappers run in solver
    loops."""
    plan = plan or _hopper_plan(ms, outs, B)
    cur = list(ms)
    out = []
    for i, j, P in plan:
        pre, post = lead * math.prod(cur[:i]), math.prod(cur[j + 1 :]) * B
        if P == 0:
            args = (ms[i], outs[i], pre, post, _wide_tile(outs[i], post))
        else:
            pad = (1,) * (3 - (j - i + 1))
            ns, os_ = ms[i : j + 1], outs[i : j + 1]
            mma = fast and _mma_tile_ok(ns, os_, P)
            if not fast:
                P, R = _exact_tile_plan(ns, os_, post, pre)
            else:
                R = (_mma_tile_rows if mma else _tile_rows)(ns, os_, P, post, pre)
            args = (j - i + 1, *ns, *pad, *os_, *pad, pre, post, P, R, int(mma))
        out.append((i, j, (pre, *outs[i : j + 1], post), P == 0, args))
        cur[i : j + 1] = outs[i : j + 1]
    return tuple(out)


def _launch(which, factors, v: torch.Tensor, fast: bool, mid_dtype, B: int, *, lead: int = 1, plan=None) -> torch.Tensor:
    """Run a pass plan on the card, one launch per pass: ``(I_lead ⊗ (⊗
    K_d)) · v`` for a contiguous ``v`` of ``lead·M·B`` elements, read as
    ``(lead·M, B)``.  ``plan`` (a tuple of passes) defaults to
    :func:`_hopper_plan`.  Returns the last pass's output, ``(pre,
    o_i..o_j, post)``: the caller reshapes it."""
    name = which.__name__
    for K in factors:
        if K.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32 factors, got {[K.dtype for K in factors]}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes a float32 or bfloat16 vector, got {v.dtype}")
    if not (v.is_contiguous() and all(K.is_contiguous() for K in factors)):
        raise ValueError(f"{name} kernel needs contiguous factors and vector")
    lib = load_library()
    ms = tuple(K.shape[1] for K in factors)
    outs = tuple(K.shape[0] for K in factors)
    passes = _passes(ms, outs, B, lead, plan, fast)
    x = v
    # The current stream's handle, as torch.cuda.current_stream(v.device)
    # .cuda_stream gives it without building a Stream object on every call.
    dev = v.device
    device = dev.index
    stream = torch._C._cuda_getCurrentRawStream(device)
    for step, (i, j, out_shape, wide, args) in enumerate(passes):
        last = step == len(passes) - 1
        odt = v.dtype if last else (mid_dtype or torch.float32)
        out = torch.empty(out_shape, dtype=odt, device=dev)
        flags = (int(fast), int(x.dtype == torch.bfloat16), int(odt == torch.bfloat16))
        if wide:
            err = lib.gp_grief_kron_wide_pass(
                x.data_ptr(), out.data_ptr(), factors[i].data_ptr(), *args, *flags, device, stream
            )
        else:
            Ks = [factors[a].data_ptr() for a in range(i, j + 1)] + [0] * (3 - (j - i + 1))
            err = lib.gp_grief_kron_tile_pass(x.data_ptr(), out.data_ptr(), *Ks, *args, *flags, device, stream)
        if err != 0:
            what = "a shape the kernel does not take" if err == _ERR_SHAPE else "CUDA error"
            raise RuntimeError(
                f"{name} pass over factors {i}..{j} of {ms} (B={B}, lead={lead}; pass output "
                f"{out_shape}) failed: {what} {err}"
            )
        which.launches += 1
        if not (wide or fast):
            which.exact_tile_launches += 1
        x = out
    return x


def _forward(which, lead: int, factors, v: torch.Tensor, fast: bool, mid_dtype) -> torch.Tensor:
    if v.is_cuda:
        return _launch(which, factors, v, fast, mid_dtype, v.shape[1], lead=lead).reshape(-1, v.shape[1])
    if v.device.type == "cpu":
        return _chain_ref(lead, factors, v, fast)
    raise ValueError(f"{which.__name__}: no kernel for device {v.device}")


def _apply(which, fast: bool, mid_dtype, v: torch.Tensor, factors) -> torch.Tensor:
    """``(⊗ K_d) · v`` through :class:`_KronMatvec` where autograd records
    it, else its forward alone (a solver's matvec: no graph to build).  A
    leading :func:`batch_identity` is folded into ``lead``."""
    lead, core = split_lead(factors)
    if torch.is_grad_enabled() and (v.requires_grad or any(K.requires_grad for K in core)):
        return _KronMatvec.apply(which, fast, mid_dtype, lead, v, *core)
    return _forward(which, lead, core, v, fast, mid_dtype)


class _KronMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, which, fast, mid_dtype, lead, v, *factors):
        ctx.lead = lead
        ctx.save_for_backward(v, *factors)
        return _forward(which, lead, factors, v, fast, mid_dtype)

    @staticmethod
    def backward(ctx, g):
        v, *factors = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (v, *factors)]
            out = _chain_ref(ctx.lead, leaves[1:], leaves[0], False)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return (None, None, None, None, *grads)


def _check(name, factors, v):
    if v.ndim not in (1, 2):
        raise ValueError(f"{name}: v must be (M,) or (M, B), got shape {tuple(v.shape)}")
    if not factors or any(K.ndim != 2 for K in factors):
        raise ValueError(f"{name}: factors must be a non-empty sequence of matrices")
    cols = math.prod(int(K.shape[1]) for K in factors)
    if v.shape[0] != cols:
        raise ValueError(f"{name}: v has {v.shape[0]} rows, the factors take {cols}")
    if any(K.device != v.device for K in factors):
        raise ValueError(f"{name}: factors and vector on different devices")


def _grade(precision: str, v: torch.Tensor) -> bool:
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    # bf16 operands carry no bits for an exact grade (as in the JAX package).
    return precision == "default" or v.dtype == torch.bfloat16


def kron_matvec_slab(
    factors: Sequence[torch.Tensor],
    v: torch.Tensor,
    *,
    precision: str = "highest",
    mid_dtype=None,
) -> torch.Tensor:
    """K2: ``(⊗ K_d) · v`` for square factors and d ≥ 3 (a leading
    :func:`batch_identity` aside, which is folded into the plan's rows); ``v``
    ``(M,)`` or ``(M, B)``.  ``mid_dtype=torch.bfloat16`` stores the vector
    between passes as bf16 (halving that traffic; meaningful at
    ``"default"``, whose operand rounding it matches).  Differentiable."""
    _check("kron_matvec_slab", factors, v)
    _, core = split_lead(factors)
    if len(core) < 3 or any(K.shape[0] != K.shape[1] for K in core):
        raise ValueError("kron_matvec_slab takes d >= 3 square factors (route with ops.kron_fast.kernel_route)")
    if mid_dtype not in (None, torch.bfloat16):
        raise ValueError(f"mid_dtype must be None or torch.bfloat16, got {mid_dtype}")
    return _wrapped(kron_matvec_slab, factors, v, precision, mid_dtype)


def kron_matvec_fused(
    factors: Sequence[torch.Tensor],
    v: torch.Tensor,
    *,
    precision: str = "highest",
) -> torch.Tensor:
    """K3: ``(⊗ K_d) · v`` for every product the Hopper plan takes
    (:func:`plan_takes`: ragged, rectangular, d ≤ 2, wide factors; a leading
    :func:`batch_identity` folded into the plan's rows); ``v`` ``(M,)`` or
    ``(M, B)``.  Differentiable."""
    _check("kron_matvec_fused", factors, v)
    return _wrapped(kron_matvec_fused, factors, v, precision, None)


def _wrapped(which, factors, v: torch.Tensor, precision: str, mid_dtype) -> torch.Tensor:
    """K2/K3 after their own checks: ``v`` ``(M,)`` or ``(M, B)``; raises
    where the plan does not take the product."""
    fast = _grade(precision, v)
    squeeze = v.ndim == 1
    vv = v[:, None] if squeeze else v
    if not plan_takes(factors, int(vv.shape[1]), fast=fast):
        raise ValueError(f"{which.__name__}: the Hopper pass plan does not take factors "
                         f"{[tuple(K.shape) for K in factors]} with B = {vv.shape[1]}")
    out = _apply(which, fast, mid_dtype, vv, factors)
    return out[:, 0] if squeeze else out


kron_matvec_slab.launches = kron_matvec_slab.exact_tile_launches = 0
kron_matvec_fused.launches = kron_matvec_fused.exact_tile_launches = 0
