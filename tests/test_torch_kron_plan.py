"""The exact grade's tile-member plan (ops/cuda/kron.py), on the CPU.

The exact member (csrc/kron_pass.cu kron_exact_tile_kernel) takes P columns
and R rows of pre a tile, lands its rows in a two-stage ring, and keeps the
transposed factors and T (the tile after its innermost contraction) beside
the ring.  These tests hold the plan to the C entry's shared-memory
arithmetic (restated here by hand), to shared memory at every shape
chip_smoke.py sends to the member, and check that the fast grade's plans are
those of the plan before the exact member was redesigned.
"""

import math
import random

import pytest

from gp_grief_tpu_torch.ops.cuda import kron as tk

# (label, factor sizes, outs or None, B, lead): the shapes chip_smoke.py
# sends to the Kronecker kernels (phases 6, 7, 9-12, 14b, 15).
SMOKE_SHAPES = [
    ("grid32x5", (32,) * 5, None, 1, 1),
    ("x3_I8_32x4", (8, 32, 32, 32, 32), None, 1, 1),
    ("ski_lattice_32x4_B8", (32,) * 4, None, 8, 1),
    ("grid8x512x512", (8, 512, 512), None, 1, 1),
    ("grid8x512x512_rank_block", (4, 512, 512), None, 1, 1),
    ("d5_4x16x8x16x8", (4, 16, 8, 16, 8), None, 1, 1),
    ("depth1024", (8, 1024, 1024), None, 1, 1),
    ("k7_32x5_B8", (32,) * 5, None, 8, 1),
    ("k7_rect_d3_B8", (80, 32, 32), (96, 24, 40), 8, 1),
    ("tail3", (32, 32, 32), None, 1, 1024),
    ("tail2", (32, 32), None, 1, 32768),
]


def _exact_passes(sizes, outs, B, lead):
    return [(args[0], list(args[1 : 1 + args[0]]), list(args[4 : 4 + args[0]]), *args[7:11])
            for *_, wide, args in tk._passes(tuple(sizes), tuple(outs or sizes), B, lead, None, False) if not wide]


def _by_hand(ns, outs, P, R, post):
    """The C entry's exact_layout, restated: bytes and units a chunk."""
    g = len(ns)
    slices = [1 << max(0, (-(-o // 8) - 1).bit_length()) for o in outs]
    kfl = sum(n * 8 * s for n, s in zip(ns, slices))
    rows = post == 1
    ls = 4 * ((-(-ns[-1] // 4)) | 1) if rows else 4 * -(-P // 4)
    if rows:
        inner = -(-outs[-1] // 4) * 4
    else:  # columns: o_last x ls, or (P not a multiple of 4) the o_last x P outputs packed
        inner = outs[-1] * ls if P % 4 == 0 else -(-(outs[-1] * P) // 4) * 4
    E = [max(n, o) for n, o in zip(ns, outs)]
    tfl = 0 if g == 1 else R * math.prod(E[:-1]) * inner
    units = R * math.prod(ns[:-1])
    rpu = 1 if rows else ns[-1]
    if g == 1:
        cu = R
    else:
        cu = 1
        while cu < units and ((-(-cu // 4)) if rows else cu * ls // 4) * slices[-1] < 256:
            cu *= 2
        cu = min(cu, units)
        while cu > 1 and 4 * (kfl + tfl + 2 * ((-(-cu // 4) * 4 if rows else cu) * rpu * ls)) > tk._SMEM_LIMIT:
            cu //= 2
    stage = (-(-cu // 4) * 4 if rows else cu) * rpu * ls
    return 4 * (kfl + tfl + 2 * stage), cu


@pytest.mark.parametrize("label,sizes,outs,B,lead", SMOKE_SHAPES, ids=[s[0] for s in SMOKE_SHAPES])
def test_exact_plan_fits_two_stages_at_the_smoke_shapes(label, sizes, outs, B, lead):
    for g, ns, os_, pre, post, P, R in _exact_passes(sizes, outs, B, lead):
        smem, cu = tk._exact_tile_layout(ns, os_, P, R, post)
        assert (smem, cu) == _by_hand(ns, os_, P, R, post)
        assert cu >= 1 and smem <= tk._SMEM_LIMIT
        assert R == 1 or P == post
        assert 1 <= P <= post


# (ns, outs, P, R, post, bytes): worked by hand.
LAYOUT_CASES = [
    # K2's first pass at 32^5 / tail3_pass: three 32x32 K^T (3·1024), T =
    # 32^3, two stages of 256 rows landed 36 floats apart.
    ([32] * 3, [32] * 3, 1, 1, 1, 4 * (3 * 1024 + 32**3 + 2 * 256 * 36)),
    # K2's second pass: T = 32 x 32 x 32 columns, stages of 8 units of 32 x 32.
    ([32, 32], [32, 32], 32, 1, 32768, 4 * (2 * 1024 + 32**3 + 2 * 8 * 32 * 32)),
    # tail2_pass: R = 8 rows of pre, T = 8 x 32 x 32, stages of 256 rows.
    ([32, 32], [32, 32], 1, 8, 1, 4 * (2 * 1024 + 8 * 32 * 32 + 2 * 256 * 36)),
    # K3's 8-deep pass at 8x512x512: no T, one unit of 8 x 1024 a stage.
    ([8], [8], 1024, 1, 262144, 4 * (8 * 8 + 2 * 8 * 1024)),
    # K7's rectangular pass: K^T of 24 and 40 outputs padded to 32 and 64;
    # T = 32 x (40 outputs x 8 columns); stages of 16 units of 32 x 8.
    ([32, 32], [24, 40], 8, 1, 8, 4 * (32 * 32 + 32 * 64 + 32 * 40 * 8 + 2 * 16 * 32 * 8)),
]


@pytest.mark.parametrize("ns,outs,P,R,post,nbytes", LAYOUT_CASES)
def test_exact_layout_by_hand(ns, outs, P, R, post, nbytes):
    assert tk._exact_tile_layout(ns, outs, P, R, post)[0] == nbytes <= tk._SMEM_LIMIT


# (ns, outs, post, pre, (P, R)): columns and rows of pre a tile.
PLAN_CASES = [
    ([32] * 3, [32] * 3, 1, 1024, (1, 1)),  # T alone is 128 KB
    ([32, 32], [32, 32], 32768, 1, (32, 1)),  # 128-byte runs
    ([32, 32], [32, 32], 1, 32768, (1, 8)),  # eight rows give the outer axis 256 tasks
    ([32, 32], [32, 32], 8, 32768, (8, 1)),  # 256 tasks from one row already
    ([8], [8], 262144, 1, (1024, 1)),  # one 8-output slice: 256 four-column groups
    ([32], [32], 8388608, 1, (256, 1)),  # four slices: 64 groups
    ([32, 32], [32, 32], 1, 3, (1, 1)),  # too few rows to batch
]


@pytest.mark.parametrize("ns,outs,post,pre,want", PLAN_CASES)
def test_exact_plan_by_hand(ns, outs, post, pre, want):
    assert tk._exact_tile_plan(ns, outs, post, pre) == want


def test_every_grouped_pass_has_an_exact_plan():
    """A sweep of ragged, rectangular shapes: every tile group the plan makes
    has an exact-member plan that fits."""
    rng = random.Random(13)
    checked = 0
    for _ in range(400):
        d = rng.randint(1, 4)
        ms = [rng.choice([1, 3, 5, 8, 12, 17, 24, 32, 40, 64, 80]) for _ in range(d)]
        outs = [rng.choice([m, rng.randint(1, 300)]) for m in ms]
        B = rng.choice([1, 1, 2, 3, 8, 13])
        for g, ns, os_, pre, post, P, R in _exact_passes(ms, outs, B, rng.choice([1, 7])):
            assert max(os_) <= tk._TILE_MAX_OUT
            assert tk._exact_tile_layout(ns, os_, P, R, post)[0] <= tk._SMEM_LIMIT
            checked += 1
    assert checked > 300


def test_outputs_past_256_take_the_wide_member():
    assert tk._hopper_plan([20, 8], [300, 8], 1) == [(1, 1, 1), (0, 0, 0)]


# The fast grade's plan as it stood before the exact member was redesigned
# (its grouping and the FP32 or tensor-core member of each tile pass).
def _old_hopper_plan(ms, outs, B):
    d = len(ms)
    passes = []
    j = d - 1
    while j >= 0:
        post = math.prod(outs[j + 1 :]) * B
        best = None
        i = j
        while i >= 0 and j - i < 3 and ms[i] <= 64:
            P = tk._tile_columns(ms[i : j + 1], outs[i : j + 1], post)
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


def _old_fast_passes(ms, outs, B, lead):
    cur = list(ms)
    out = []
    for i, j, P in _old_hopper_plan(ms, outs, B):
        pre, post = lead * math.prod(cur[:i]), math.prod(cur[j + 1 :]) * B
        if P == 0:
            args = (ms[i], outs[i], pre, post, tk._wide_tile(outs[i], post))
        else:
            pad = (1,) * (3 - (j - i + 1))
            ns, os_ = ms[i : j + 1], outs[i : j + 1]
            mma = tk._mma_tile_ok(ns, os_, P)
            R = (tk._mma_tile_rows if mma else tk._tile_rows)(ns, os_, P, post, pre)
            args = (j - i + 1, *ns, *pad, *os_, *pad, pre, post, P, R, int(mma))
        out.append((i, j, (pre, *outs[i : j + 1], post), P == 0, args))
        cur[i : j + 1] = outs[i : j + 1]
    return tuple(out)


def _fast_cases():
    cases = [(s[1], s[2] or s[1], s[3], s[4]) for s in SMOKE_SHAPES]
    rng = random.Random(17)
    for _ in range(300):
        d = rng.randint(1, 5)
        ms = tuple(rng.choice([2, 4, 7, 8, 16, 20, 32, 48, 64, 96, 512]) for _ in range(d))
        outs = tuple(rng.choice([m, rng.randint(1, 64)]) for m in ms)
        cases.append((ms, outs, rng.choice([1, 3, 8, 16]), rng.choice([1, 5])))
    return cases


def test_fast_grade_plans_unchanged():
    for ms, outs, B, lead in _fast_cases():
        assert tk._passes(tuple(ms), tuple(outs), B, lead, None, True) == _old_fast_passes(ms, outs, B, lead), (ms, outs, B)
