"""K5's host plan (ops/cuda/stencil.py:stencil_plan), applied in plain torch
on the CPU as the window member applies it on the card.

For each work item of ``cells`` cells and each slab of ``rows`` rows, each
group's window is cut from the zero-padded v at the plan's base and width,
and the group's offsets are taken from it in plan order.  The result must
equal the plain version ``stencil_apply_ref`` bit for bit (the same products
added in the same order: the plan keeps the offsets' ascending order), and
match the JAX package's Pallas kernel in interpret mode (1e-12 of the output
scale, float64: another order of the same sums).  The plan's choice of member
is asserted for the configurations' lattice and the test shapes.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gp_grief_tpu.ops import interp as jint
from gp_grief_tpu.ops import interp_stencil as jst
from gp_grief_tpu_torch.ops import interp as tint
from gp_grief_tpu_torch.ops import interp_stencil as tst
from gp_grief_tpu_torch.ops.cuda.stencil import SMEM_LIMIT, stencil_plan

torch.set_num_threads(1)

# tests/test_torch_stencil.py's shapes and the phase-8 ragged lattice.
SHAPES = [((6,), 17), ((5, 4), 30), ((5, 4, 3), 50), ((4, 3, 3, 2), 64), ((3, 1, 4), 21),
          ((8, 6, 5, 4), 300), ((8, 32, 4, 2), 400), ((23, 17, 29), 3000)]
DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def _case(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    xg = [np.sort(rng.uniform(0, 1, m)) for m in shape]
    x = rng.uniform(-0.1, 1.2, size=(n, len(shape)))
    return x, xg


def _stencil(shape, n, dtype):
    x, xg = _case(shape, n)
    return tst.build_wtw_stencil(tint.interp_weights(x, xg), dtype=dtype, device="cpu")


def _plan(st, B, dtype):
    return stencil_plan(st.shape, st.deltas, st.d0s, B, torch.empty(0, dtype=dtype).element_size())


def _apply_planned(st, v, plan):
    """The window member's arithmetic in plain torch, item by item."""
    B, M = v.shape
    C, R = plan.cells, plan.rows
    tiles = -(-M // C)
    left = max(0, -min(g[2] for g in plan.groups))
    right = max(0, (tiles - 1) * C + max(g[2] + g[3] for g in plan.groups) - M)
    vp = torch.nn.functional.pad(v, (left, right))  # zeros outside [0, M)
    tables = torch.nn.functional.pad(st.tables, (0, tiles * C - M))
    out = torch.empty_like(v)
    covered = []
    for slab in range(plan.slabs):
        rows = slice(slab * R, min(B, (slab + 1) * R))
        for t in range(tiles):
            c0 = t * C
            acc = torch.zeros((rows.stop - rows.start, C), dtype=v.dtype)
            for begin, end, base, width in plan.groups:
                assert width <= plan.pitch and base % (16 // v.element_size()) == 0
                win = vp[rows, left + c0 + base:left + c0 + base + width]
                assert win.shape[1] == width
                for i in range(begin, end):
                    loc = st.deltas[i] - base
                    assert 0 <= loc and loc + C <= width
                    acc = acc + tables[i, c0:c0 + C][None, :] * win[:, loc:loc + C]
                    if slab == 0 and t == 0:
                        covered.append(i)
            out[rows, c0:min(c0 + C, M)] = acc[:, :min(C, M - c0)]
    assert covered == list(range(len(st.deltas)))  # every offset once, in ascending order
    return out


@pytest.mark.parametrize("B", [1, 9, 17])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,n", SHAPES)
def test_window_plan_keeps_the_plain_versions_bits(shape, n, dtype, B):
    st = _stencil(shape, n, dtype)
    plan = _plan(st, B, dtype)
    assert plan.member == "window"
    assert plan.rows <= 16 and plan.slabs * plan.rows >= B and plan.smem_bytes <= SMEM_LIMIT
    v = torch.as_tensor(np.random.default_rng(1).standard_normal((B, st.M)).astype(DTYPES[dtype]))
    assert torch.equal(_apply_planned(st, v, plan), tst.stencil_apply_ref(st, v))


@pytest.mark.parametrize("shape,n", SHAPES)
def test_window_plan_matches_pallas_kernel(shape, n):
    x, xg = _case(shape, n)
    js = jst.build_wtw_stencil(jint.interp_weights(jnp.asarray(x), [jnp.asarray(g) for g in xg]))
    st = _stencil(shape, n, torch.float64)
    v = np.random.default_rng(2).standard_normal((9, st.M))
    got = _apply_planned(st, torch.as_tensor(v), _plan(st, 9, torch.float64)).numpy()
    want = np.asarray(jst.wtw_stencil_bm(js, jnp.asarray(v), block_cells=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(1.0, float(np.abs(want).max())))


def _lattice_offsets(shape):
    """Every flat offset of {-1, 0, 1}^d on a lattice whose extents are all
    ≥ 2, ascending, with its leading component: what build_wtw_stencil gives
    where the data cover the lattice."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    offs = sorted((sum(o * s for o, s in zip(c, strides)), c[0]) for c in itertools.product((-1, 0, 1), repeat=len(shape)))
    return tuple(o for o, _ in offs), tuple(f for _, f in offs)


def test_lattice_offsets_are_the_builds():
    st = _stencil((8, 6, 5, 4), 3000, torch.float64)
    assert (st.deltas, st.d0s) == _lattice_offsets((8, 6, 5, 4))


@pytest.mark.parametrize("dtype,B,member,cells,buffers", [
    (torch.float32, 9, "window", 1024, 2),   # ski1m_lattice's whitened applies: two 113 KB windows
    (torch.float32, 1, "window", 1024, 2),
    (torch.float32, 17, "window", 1024, 2),  # two slabs of 9
    (torch.float32, 130, "window", 1024, 1),  # slabs of 15: one 189 KB window
    (torch.float32, 256, "window", 1024, 1),  # a predict chunk: slabs of 16
    (torch.float64, 9, "window", 1024, 1),   # the float64 runs: one 226 KB window
    (torch.float64, 16, "cell", 0, 0),       # 16 rows of float64: no window fits
    (torch.float64, 256, "cell", 0, 0),
])
def test_plan_at_the_configurations_lattice(dtype, B, member, cells, buffers):
    deltas, d0s = _lattice_offsets((32,) * 4)
    plan = stencil_plan((32,) * 4, deltas, d0s, B, torch.empty(0, dtype=dtype).element_size())
    assert (plan.member, plan.cells, plan.buffers) == (member, cells, buffers)
    assert plan.slabs == -(-B // 16)
    if member == "window":
        # Three leading-component groups of 27 offsets, each a window of
        # C + 2·1057 cells (+ alignment) at 32^4.
        assert [(b, e) for b, e, _, _ in plan.groups] == [(0, 27), (27, 54), (54, 81)]
        assert plan.pitch == max(w for *_, w in plan.groups) <= 1024 + 2 * 1057 + 8
        assert plan.smem_bytes <= SMEM_LIMIT


def test_plan_members_of_other_shapes():
    # A size-1 extent: its offsets vanish and the groups keep their order.
    st = _stencil((3, 1, 4), 21, torch.float64)
    assert _plan(st, 9, torch.float64).member == "window"
    # One group where the lattice is small, three where the groups lie apart.
    assert len(_plan(_stencil((8, 6, 5, 4), 300, torch.float32), 9, torch.float32).groups) == 1
    assert len(_plan(_stencil((23, 17, 29), 3000, torch.float32), 9, torch.float32).groups) == 3
    # Cells per item follow the card's SM count: 240 items of 1024 cells fill
    # 114 SMs twice over, not 132.
    deltas, d0s = _lattice_offsets((16, 16, 16, 60))
    assert stencil_plan((16, 16, 16, 60), deltas, d0s, 9, 4, sms=114).cells == 1024
    assert stencil_plan((16, 16, 16, 60), deltas, d0s, 9, 4, sms=132).cells == 128
    # 32^5: no window of ±33,825 cells fits shared memory.
    deltas, d0s = _lattice_offsets((32,) * 5)
    assert stencil_plan((32,) * 5, deltas, d0s, 9, 4).member == "cell"
    # Offsets whose leading components alternate more than three times
    # cannot be taken group by group in ascending order.
    assert stencil_plan((4, 4), (-2, -1, 0, 1), (0, 1, 0, 1), 9, 4).member == "cell"
    assert stencil_plan((4, 4), (-2, -1, 0, 1), (0, 1, 1, 1), 9, 4).member == "window"
