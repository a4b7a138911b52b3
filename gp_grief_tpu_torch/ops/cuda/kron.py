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
launches (one per pass) and nothing else.  The backward pass is the vector-
Jacobian product of the exact plain chain, as in the JAX package's custom
VJPs: the TPU kernels had no backward kernel either.

Grades (``precision``): ``"highest"`` is exact f32; ``"default"`` rounds
every operand of every contraction to bf16 and accumulates in f32.  A bf16
input vector forces ``"default"`` and gives a bf16 result.

The routing gates :func:`slab_schedule_applicable`,
:func:`fused_schedule_applicable` and :func:`_fused_schedule` are copied from
``kron_pallas.py`` unchanged, so that ``ops.kron_fast.kron_matvec_fast``
sends a given shape and precision to the same kernel as the JAX package.
Their lane and VMEM arithmetic describes the TPU kernels, not these; gates
derived for Hopper are later work.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = [
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

_TILE_MAX_AXIS = 64  # fibre registers a thread holds (csrc: MAXN <= 64)
_TILE_MAX_GROUP = 3
_SMEM_LIMIT = 232448  # bytes of shared memory a block can use on sm_90
_TILE_MAX_P = 128
_COALESCED_P = 32  # 128-byte rows of f32: the least run worth a global load


def _tile_smem_bytes(ns, outs, P: int) -> int:
    """Shared memory of one tile-pass block; the same arithmetic as
    ``gp_grief_kron_tile_pass`` in csrc/kron_pass.cu."""
    ext = [max(n, o) for n, o in zip(ns, outs)] + ([P] if P > 1 else [])
    ext[-1] |= 1  # odd innermost extent: fibres along it fall in distinct banks
    tile = math.prod(ext)
    floats = -(-tile // 4) * 4 + sum(o * (-(-n // 4) * 4) for n, o in zip(ns, outs))
    return 4 * floats


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
    ``i..j``.  ``P = 0`` marks a wide pass (one axis of more than 64 points,
    a GEMM); otherwise a tile pass of up to three axes with ``P`` trailing
    columns per block.  A group grows leftwards while its tile still fits
    shared memory with coalesced loads."""
    d = len(ms)
    passes = []
    j = d - 1
    while j >= 0:
        post = math.prod(outs[j + 1 :]) * B
        best = None
        i = j
        while i >= 0 and j - i < _TILE_MAX_GROUP and ms[i] <= _TILE_MAX_AXIS:
            P = _tile_columns(ms[i : j + 1], outs[i : j + 1], post)
            if P == 0:
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


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def kron_chain_ref(factors: Sequence[torch.Tensor], v: torch.Tensor, *, fast: bool = False) -> torch.Tensor:
    """Plain version of K2 and K3: ``(⊗ K_d) · v`` for ``v`` ``(M, B)``, one
    ``tensordot`` per axis from the last to the first, as the kernels'
    passes run.  ``fast`` rounds both operands of every contraction to bf16
    (products accumulate in the working precision), which also stands for
    the kernels' bf16 storage between passes.  Computes in float64 for a
    float64 ``v``, else float32; returns ``v``'s dtype."""
    work = torch.float64 if v.dtype == torch.float64 else torch.float32
    ms = [int(K.shape[1]) for K in factors]
    cur = list(ms)
    B = int(v.shape[1])
    x = v.to(work)
    for t in reversed(range(len(factors))):
        K = factors[t].to(work)
        if fast:
            K, x = _bf16_round(K), _bf16_round(x)
        pre, post = math.prod(cur[:t]), math.prod(cur[t + 1 :]) * B
        x = torch.einsum("ok,pkq->poq", K, x.reshape(pre, cur[t], post))
        cur[t] = int(K.shape[0])
    return x.reshape(-1, B).to(v.dtype)


def _launch(which, factors, v: torch.Tensor, fast: bool, mid_dtype) -> torch.Tensor:
    """Run the Hopper pass plan on the card: one launch per pass."""
    name = which.__name__
    if any(K.dtype != torch.float32 for K in factors):
        raise TypeError(f"{name} kernel takes float32 factors, got {[K.dtype for K in factors]}")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes a float32 or bfloat16 vector, got {v.dtype}")
    if not (v.is_contiguous() and all(K.is_contiguous() for K in factors)):
        raise ValueError(f"{name} kernel needs contiguous factors and vector")
    from gp_grief_tpu_torch.ops.cuda._build import load_library

    lib = load_library()
    ms = [int(K.shape[1]) for K in factors]
    outs = [int(K.shape[0]) for K in factors]
    B = int(v.shape[1])
    plan = _hopper_plan(ms, outs, B)
    cur = list(ms)
    x = v
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        for step, (i, j, P) in enumerate(plan):
            last = step == len(plan) - 1
            odt = v.dtype if last else (mid_dtype or torch.float32)
            pre, post = math.prod(cur[:i]), math.prod(cur[j + 1 :]) * B
            shape = (pre, *outs[i : j + 1], post)
            out = torch.empty(shape, dtype=odt, device=v.device)
            flags = (int(fast), int(x.dtype == torch.bfloat16), int(odt == torch.bfloat16))
            if P == 0:
                err = lib.gp_grief_kron_wide_pass(
                    x.data_ptr(), out.data_ptr(), factors[i].data_ptr(), ms[i], outs[i], pre, post,
                    *flags, stream,
                )
            else:
                Ks = [factors[a].data_ptr() for a in range(i, j + 1)] + [0] * (3 - (j - i + 1))
                ns = ms[i : j + 1] + [1] * (3 - (j - i + 1))
                os_ = outs[i : j + 1] + [1] * (3 - (j - i + 1))
                err = lib.gp_grief_kron_tile_pass(
                    x.data_ptr(), out.data_ptr(), *Ks, j - i + 1, *ns, *os_, pre, post, P, *flags, stream,
                )
            if err != 0:
                raise RuntimeError(
                    f"{name} pass over factors {i}..{j} of {tuple(ms)} (B={B}) failed with error {err}"
                )
            which.launches += 1
            cur[i : j + 1] = outs[i : j + 1]
            x = out
    return x.reshape(-1, B)


class _KronMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, which, fast, mid_dtype, v, *factors):
        ctx.save_for_backward(v, *factors)
        if v.device.type == "cuda":
            return _launch(which, factors, v, fast, mid_dtype)
        if v.device.type == "cpu":
            return kron_chain_ref(factors, v, fast=fast)
        raise ValueError(f"{which.__name__}: no kernel for device {v.device}")

    @staticmethod
    def backward(ctx, g):
        v, *factors = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (v, *factors)]
            out = kron_chain_ref(leaves[1:], leaves[0])
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        return (None, None, None, *grads)


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
    """K2: ``(⊗ K_d) · v`` for square factors and d ≥ 3; ``v`` ``(M,)`` or
    ``(M, B)``.  ``mid_dtype=torch.bfloat16`` stores the vector between
    passes as bf16 (halving that traffic; meaningful at ``"default"``, whose
    operand rounding it matches).  Differentiable."""
    _check("kron_matvec_slab", factors, v)
    if len(factors) < 3 or any(K.shape[0] != K.shape[1] for K in factors):
        raise ValueError("kron_matvec_slab takes d >= 3 square factors (gate with slab_schedule_applicable)")
    if mid_dtype not in (None, torch.bfloat16):
        raise ValueError(f"mid_dtype must be None or torch.bfloat16, got {mid_dtype}")
    squeeze = v.ndim == 1
    vv = v[:, None] if squeeze else v
    out = _KronMatvec.apply(kron_matvec_slab, _grade(precision, v), mid_dtype, vv, *factors)
    return out[:, 0] if squeeze else out


def kron_matvec_fused(
    factors: Sequence[torch.Tensor],
    v: torch.Tensor,
    *,
    precision: str = "highest",
) -> torch.Tensor:
    """K3: ``(⊗ K_d) · v`` for every shape :func:`_fused_schedule` plans
    (ragged, rectangular, d = 2, leading identity); ``v`` ``(M,)`` or
    ``(M, B)``.  Differentiable."""
    _check("kron_matvec_fused", factors, v)
    B = 1 if v.ndim == 1 else int(v.shape[1])
    ms = [int(K.shape[1]) for K in factors]
    outs = [int(K.shape[0]) for K in factors]
    if _fused_schedule(ms, outs, B, int(factors[0].dtype.itemsize)) is None:
        raise ValueError("kron_matvec_fused: no feasible plan (gate with fused_schedule_applicable)")
    squeeze = v.ndim == 1
    vv = v[:, None] if squeeze else v
    out = _KronMatvec.apply(kron_matvec_fused, _grade(precision, v), None, vv, *factors)
    return out[:, 0] if squeeze else out


kron_matvec_slab.launches = 0
kron_matvec_fused.launches = 0
