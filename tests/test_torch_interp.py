"""The port's interpolation operators (ops/interp.py) and K4's plain version
against the JAX package's, float64 on the CPU, on the same NumPy inputs.

Tolerances: the weights, the corner stream and the plan are the same NumPy
arithmetic (compared exactly); the applies reorder short float64 sums
(1e-12 relative to the output scale)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gp_grief_tpu.ops import interp as jint
from gp_grief_tpu_torch.ops import interp as tint
from gp_grief_tpu_torch.ops.cuda import interp as interp_wt_module, interp_wt

torch.set_num_threads(1)

TOL = 1e-12


def _case(shape, n, seed=0, spread=(-0.2, 1.2)):
    """Points (some outside the box, some on grid lines) and sorted grids;
    a dimension of size 1 is degenerate."""
    rng = np.random.default_rng(seed)
    xg = [np.sort(rng.uniform(0, 1, m)) if m > 1 else np.array([0.5]) for m in shape]
    x = rng.uniform(*spread, size=(n, len(shape)))
    x[: n // 10, 0] = xg[0][len(xg[0]) // 2]  # zero right weights: pruned stream entries
    return x, xg


SHAPES = [((6, 7, 5), 300), ((8, 1, 4), 120), ((5,), 40), ((3, 4, 3, 2), 200)]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("shape,n", SHAPES)
def test_interp_weights_match_jax(shape, n):
    """Host (NumPy) and device (torch.searchsorted) paths give the JAX
    package's indices and weights, clamping and degenerate dimensions
    included."""
    x, xg = _case(shape, n)
    j = jint.interp_weights(jnp.asarray(x), [jnp.asarray(g) for g in xg])
    h = tint.interp_weights(x, xg)
    t = tint.interp_weights(torch.as_tensor(x), [torch.as_tensor(g) for g in xg])
    assert h.shape == t.shape == tuple(shape)
    for d in range(len(shape)):
        np.testing.assert_array_equal(h.idx[d], np.asarray(j.idx[d]))
        np.testing.assert_array_equal(t.idx[d].numpy(), np.asarray(j.idx[d]))
        np.testing.assert_array_equal(h.w[d], np.asarray(j.w[d]))
        np.testing.assert_allclose(t.w[d].numpy(), np.asarray(j.w[d]), rtol=0, atol=1e-15)


@pytest.mark.parametrize("shape,n", SHAPES)
def test_corner_stream_and_plan_match_jax(shape, n):
    x, xg = _case(shape, n, seed=1)
    jw = jint.interp_weights(jnp.asarray(x), [jnp.asarray(g) for g in xg])
    tw = tint.interp_weights(x, xg)
    js, ts = jint.build_corner_stream(jw), tint.build_corner_stream(tw)
    for field in tint.CornerStream._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ts, field)), np.asarray(getattr(js, field)), err_msg=field)
    jp = jint.build_interp_plan(jw, stream=js)
    tp = tint.build_interp_plan(tw, stream=ts)
    for field in ("src_col", "w_sorted", "start_ptr", "end_ptr", "gather_flat", "gather_w", "slot_src", "slot_w",
                  "ov_ids", "ov_src", "ov_w"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)), err_msg=field)
    assert tp.M == math.prod(shape) and tp.n == n


@pytest.mark.parametrize("shape,n", SHAPES)
def test_applies_match_jax(shape, n):
    x, xg = _case(shape, n, seed=2)
    rng = np.random.default_rng(3)
    M, B = math.prod(shape), 3
    jw = jint.interp_weights(jnp.asarray(x), [jnp.asarray(g) for g in xg])
    tw = tint.iw_to_torch(tint.interp_weights(x, xg), dtype=torch.float64, device="cpu")
    jp, tp = jint.build_interp_plan(jw), tint.build_interp_plan(tint.interp_weights(x, xg))
    v, u = rng.standard_normal((M, B)), rng.standard_normal((n, B))
    vt, ut = torch.as_tensor(v), torch.as_tensor(u)
    _close(tint.interp_matvec(tw, vt).numpy(), jint.interp_matvec(jw, jnp.asarray(v)))
    _close(tint.interp_rmatvec(tw, ut).numpy(), jint.interp_rmatvec(jw, jnp.asarray(u)))
    _close(tint.interp_matvec_bm(tw, vt.T).numpy(), jint.interp_matvec_bm(jw, jnp.asarray(v.T)))
    _close(tint.interp_rmatvec_bm(tw, ut.T).numpy(), jint.interp_rmatvec_bm(jw, jnp.asarray(u.T)))
    _close(tint.interp_matvec_bm_fast(tp, vt.T).numpy(), jint.interp_matvec_bm_fast(jp, jnp.asarray(v.T)))
    _close(tint.interp_rmatvec_bm_fast(tp, ut.T).numpy(), jint.interp_rmatvec_bm_fast(jp, jnp.asarray(u.T)))
    _close(tint.interp_rmatvec_bm_exact(tp, ut.T).numpy(), jint.interp_rmatvec_bm_exact(jp, jnp.asarray(u.T)))
    np.testing.assert_allclose(tint.interp_expand(tw).numpy(), np.asarray(jint.interp_expand(jw)), rtol=0, atol=0)


def test_k4_plain_version_matches_onehot_kernel_and_scatter():
    """K4's wrapper on CPU tensors (its plain version, the exact ELL form)
    against the one-hot Pallas kernel in interpret mode, with its overflow
    path exercised, and against the scatter form."""
    rng = np.random.default_rng(0)
    n, B = 400, 5
    x = rng.uniform(0, 3, size=(n, 3))
    x[:40, 0] = np.linspace(0, 3, 7)[3]
    xg = [np.linspace(0, 3, m) for m in (7, 5, 6)]
    jw = jint.interp_weights(jnp.asarray(x), [jnp.asarray(g)[:, None] for g in xg])
    oplan = jint.build_onehot_plan(jw, ov_limit=10**9)
    assert oplan is not None and int(oplan.ov_ids.shape[0]) > 0
    onehot = jint.make_onehot_rmatvec(jint.build_interp_plan(jw), oplan, interpret=True)
    tp = tint.build_interp_plan(tint.interp_weights(x, xg))
    u = rng.standard_normal((B, n))
    before = interp_wt.launches
    got = interp_wt(tp, torch.as_tensor(u)).numpy()
    assert interp_wt.launches == before  # CPU tensors: the plain version, no launch
    _close(got, onehot(jnp.asarray(u)))
    _close(got, jint.interp_rmatvec_bm(jw, jnp.asarray(u)))


def test_k4_backward_is_the_forward_interpolation():
    rng = np.random.default_rng(4)
    x, xg = _case((5, 4, 3), 90, seed=4)
    tp = tint.build_interp_plan(tint.interp_weights(x, xg))
    W = tint.interp_expand(tint.iw_to_torch(tint.interp_weights(x, xg), dtype=torch.float64, device="cpu"))
    u = torch.tensor(rng.standard_normal((2, 90)), requires_grad=True)
    c = torch.as_tensor(rng.standard_normal((2, 60)))
    (g,) = torch.autograd.grad(torch.sum(interp_wt(tp, u) * c), u)
    np.testing.assert_allclose(g.numpy(), (c @ W.T).numpy(), rtol=1e-12, atol=1e-13)


def test_k4_wrapper_rejects_mismatched_operands():
    x, xg = _case((4, 4), 30)
    tp = tint.build_interp_plan(tint.interp_weights(x, xg))
    with pytest.raises(ValueError, match=r"\(B, 30\)"):
        interp_wt(tp, torch.zeros((2, 31), dtype=torch.float64))


def _clustered(shape=(16, 16, 16), n=3000, seed=6):
    """Most points in a few cells (hundreds of stream entries each), the rest
    scattered: segments longer than the kernel's warp threshold, and many
    empty cells."""
    rng = np.random.default_rng(seed)
    xg = [np.linspace(0, 1, m) for m in shape]
    x = rng.uniform(0, 1, size=(n, len(shape)))
    x[: n // 2] = 0.5 + 0.01 * rng.standard_normal((n // 2, len(shape)))
    x[n // 2 : 3 * n // 4] = 0.2 + 0.003 * rng.standard_normal((n // 4, len(shape)))
    return x, xg


@pytest.mark.parametrize("geometry", ["clustered", *(f"{s}-{n}" for s, n in SHAPES)])
def test_k4_plan_segments_follow_one_another(geometry):
    """K4 walks a block's cells as one contiguous stream range: each cell's
    segment starts where the previous one ends."""
    x, xg = _clustered() if geometry == "clustered" else _case(*dict((f"{s}-{n}", (s, n)) for s, n in SHAPES)[geometry])
    tp = tint.build_interp_plan(tint.interp_weights(x, xg))
    start, end = tp.start_ptr.long(), tp.end_ptr.long()
    assert int(start[0]) == 0 and int(end[-1]) == int(tp.src_col.shape[0])
    assert torch.equal(start[1:], end[:-1]) and bool((end >= start).all())
    if geometry == "clustered":
        lengths = end - start
        assert int(lengths.max()) > 256 and int((lengths == 0).sum()) > tp.M // 4


@pytest.mark.parametrize("B", [1, 3, 9])
def test_k4_operand_layout_strides(B):
    """The operand the wrapper hands K4: ``u`` point-major, element ``(b, p)``
    at ``p * B + b``.  Summing each cell's segment through that addressing
    (the kernel's) gives the plain version, on the clustered plan."""
    x, xg = _clustered()
    tp = tint.build_interp_plan(tint.interp_weights(x, xg))
    u = torch.as_tensor(np.random.default_rng(B).standard_normal((B, x.shape[0])))
    ua = interp_wt_module.u_layout(u)
    assert ua.is_contiguous() and tuple(ua.shape) == (x.shape[0], B)
    flat = ua.reshape(-1)
    src = tp.src_col.long()
    cell = torch.repeat_interleave(torch.arange(tp.M), (tp.end_ptr - tp.start_ptr).long())
    vals = tp.w_sorted[None, :] * flat[src[None, :] * B + torch.arange(B)[:, None]]
    got = torch.zeros((B, tp.M), dtype=u.dtype).index_add_(1, cell, vals)
    _close(got.numpy(), tint.interp_rmatvec_bm_exact(tp, u).numpy())
