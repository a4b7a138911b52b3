"""The port's WᵀW stencil (ops/interp_stencil.py) and K5's plain version
against the JAX package's, float64 on the CPU, on the same NumPy inputs.

Tolerances: the tables are the same NumPy float64 bincounts (compared
exactly); the applies reorder the D-term sums (1e-12 relative to the output
scale)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gp_grief_tpu.ops import interp as jint
from gp_grief_tpu.ops import interp_stencil as jst
from gp_grief_tpu_torch.ops import interp as tint
from gp_grief_tpu_torch.ops import interp_stencil as tst
from gp_grief_tpu_torch.ops.cuda import wtw_stencil

torch.set_num_threads(1)

TOL = 1e-12


def _case(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    xg = [np.sort(rng.uniform(0, 1, m)) for m in shape]
    x = rng.uniform(-0.1, 1.2, size=(n, len(shape)))  # exercises clamping
    jw = jint.interp_weights(jnp.asarray(x), [jnp.asarray(g) for g in xg])
    tw = tint.interp_weights(x, xg)
    W = tint.interp_expand(tint.iw_to_torch(tw, dtype=torch.float64, device="cpu")).numpy()
    return jw, tw, W


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("shape,n", [((6,), 17), ((5, 4), 30), ((5, 4, 3), 50), ((4, 3, 3, 2), 64), ((3, 1, 4), 21)])
def test_stencil_tables_and_apply_match_jax_and_dense(shape, n):
    jw, tw, W = _case(shape, n)
    js, ts = jst.build_wtw_stencil(jw), tst.build_wtw_stencil(tw)
    assert ts.deltas == js.deltas and ts.d0s == js.d0s and ts.shape == js.shape
    np.testing.assert_array_equal(ts.tables.numpy(), np.asarray(js.tables))
    v = np.random.default_rng(1).standard_normal((3, math.prod(shape)))
    before = wtw_stencil.launches
    got = tst.wtw_stencil_bm(ts, torch.as_tensor(v)).numpy()
    assert wtw_stencil.launches == before  # CPU tensors: the plain version
    _close(got, jst.wtw_stencil_bm(js, jnp.asarray(v)))
    _close(got, v @ (W.T @ W).T)


@pytest.mark.parametrize("shape,n,block", [((8, 6, 5, 4), 300, 128), ((8, 32, 4, 2), 400, 128)],
                         ids=["one-window", "three-windows"])
def test_k5_plain_version_matches_pallas_kernel(shape, n, block):
    """Against the TPU kernel in interpret mode, in both of its window modes
    (one window over all offsets; three leading-dimension windows when
    stride0 > block + 2·S_rest)."""
    jw, tw, _ = _case(shape, n, seed=2)
    js, ts = jst.build_wtw_stencil(jw), tst.build_wtw_stencil(tw)
    v = np.random.default_rng(3).standard_normal((5, math.prod(shape)))
    want = jst.wtw_stencil_bm(js, jnp.asarray(v), block_cells=block, interpret=True)
    _close(tst.stencil_apply_ref(ts, torch.as_tensor(v)).numpy(), want)


def test_k5_backward_is_the_same_stencil():
    _, tw, W = _case((5, 4, 3), 40, seed=4)
    ts = tst.build_wtw_stencil(tw)
    rng = np.random.default_rng(5)
    v = torch.tensor(rng.standard_normal((2, 60)), requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(torch.sin(tst.make_wtw_stencil_op(ts)(v))), v)
    A = W.T @ W
    want = np.cos(v.detach().numpy() @ A.T) @ A
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-11, atol=1e-12)


def test_stencil_gates_and_empty_data():
    _, tw, _ = _case((6, 5, 4), 30)
    assert tst.build_wtw_stencil(tw, max_table_bytes=64) is None
    x7 = np.random.default_rng(0).uniform(0, 1, (10, 7))
    assert tst.build_wtw_stencil(tint.interp_weights(x7, [np.linspace(0, 1, 2)] * 7)) is None  # d > 6
    empty = tst.build_wtw_stencil(tint.interp_weights(np.zeros((0, 2)), [np.linspace(0, 1, 5), np.linspace(0, 1, 4)]))
    np.testing.assert_array_equal(tst.wtw_stencil_bm(empty, torch.ones((2, 20), dtype=torch.float64)).numpy(), 0.0)
