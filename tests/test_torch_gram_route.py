"""Kernel K9's route (``ops.cuda.gram``) on the CPU: which solver applies of
``make_gram_matvec`` it takes, how it cuts ``B`` and splits columns, and its
plain version against the slab path.

The predicate takes the device type, dtype, kernel and ``d``, so it runs
without a card.  The plain version repeats K9's arithmetic (direct
differences, the variance and ``σ² vv`` after the sum) in float64, where it
agrees with the slab path to rounding (1e-12).  The wiring of the fused
branch (its counter, the roles it leaves to the slab path) runs on the CPU
with the predicate forced true: ``gram_apply`` on CPU tensors is the plain
version.
"""

import pytest
import torch

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.kernels import extra
from gp_grief_tpu_torch.models import gp_regression as tgr
from gp_grief_tpu_torch.ops.cuda import gram
from gp_grief_tpu_torch.utils import profiling

torch.set_num_threads(1)

KINDS = ("rbf", "exponential", "matern12", "matern32", "matern52")
F32 = torch.float32


def _kern(kind="rbf", d=2, dtype=torch.float64, ard=True):
    ls = torch.linspace(0.6, 1.1, d, dtype=torch.float64) if ard else 0.8
    return gpt.make_kernel(kind, lengthscale=ls, variance=1.3, dtype=dtype)


def _data(n=300, d=2, B=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = 3.0 * torch.rand((n, d), generator=g, dtype=torch.float64)
    return x, torch.randn((B, n), generator=g, dtype=torch.float64)


@pytest.mark.parametrize("kernels, device_type, dtype, d", [
    (_kern(dtype=F32), "cpu", F32, 2),
    (_kern(dtype=torch.float64), "cpu", torch.float64, 2),
    ([_kern(d=1, dtype=F32), _kern(d=1, dtype=F32)], "cuda", F32, 2),
    (extra.RatQuad(torch.tensor(0.0), torch.tensor(0.0), torch.tensor(0.0)).to(F32), "cuda", F32, 2),
    (extra.Sum(_kern(dtype=F32), _kern(dtype=F32)), "cuda", F32, 2),
    (_kern(dtype=torch.bfloat16), "cuda", torch.bfloat16, 2),
    (_kern(d=gram.MAX_DIM + 1, dtype=F32), "cuda", F32, gram.MAX_DIM + 1),
    (_kern(dtype=torch.float64), "cuda", F32, 2),
], ids=["cpu-f32", "cpu-f64", "product", "ratquad", "sum", "bf16", "wide", "f64-params-f32-x"])
def test_the_slab_path_keeps(kernels, device_type, dtype, d):
    assert not gram.fused_route(kernels, device_type, dtype, d)


@pytest.mark.parametrize("dtype", [F32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_route_takes_each_stationary_kind(kind, dtype):
    for d in (1, 3, gram.MAX_DIM):
        assert gram.fused_route(_kern(kind, d, dtype), "cuda", dtype, d)
    assert gram.fused_route(_kern(kind, 1, dtype, ard=False), "cuda", dtype, 5)


@pytest.mark.parametrize("B", [1, 2, 4, 8, 9, 12, 16, 17, 33, 40, 1024])
def test_b_tiles_cover_b_in_fewest_tiles(B):
    t = gram.b_tile(B)
    assert t in gram.B_TILES
    assert -(-B // t) == -(-B // gram.B_TILES[-1])


def test_splits():
    assert gram.splits(2 * 792, 792, 632) == 1  # two waves of row tiles: no split
    # gp40k's (9, 40000, 2): 79 row tiles over 792 resident blocks, 632 column tiles.
    s = gram.splits(79, 792, 632)
    assert 79 * s <= 792 and 79 * (s + 1) > 792
    assert gram.splits(3, 4, 2) == 1  # never more splits than column tiles
    assert all(1 <= gram.splits(c, 528, 16) <= 16 for c in range(1, 1200, 37))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_is_the_slab_apply(kind, d, precision):
    x, V = _data(d=d)
    k = _kern(kind, d)
    sig = torch.tensor(0.3, dtype=torch.float64)
    with torch.no_grad():
        want = tgr.make_gram_matvec(k, x, sig, chunk=128, precision=precision)(V)
        got = gram.gram_apply(k, x, V, sig, precision)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_gram_apply_checks_its_operands():
    x, V = _data()
    k = _kern()
    with pytest.raises(ValueError):
        gram.gram_apply(k, x, V[:, :-1], 0.3)
    with pytest.raises(TypeError):
        gram.gram_apply(k, x, V.float(), 0.3)
    with pytest.raises(ValueError):
        gram.gram_apply(k, x, V, 0.3, "low")


def _applies(mv, V, k):
    """Under a profiler: a solver apply, a bf16 apply and a differentiated
    apply; the counters and the ``gp_grief.gram`` calls after."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            out = mv(V)
            mv(V.to(torch.bfloat16))
        k.log_variance.requires_grad_(True)
        mv(V).sum().backward()
    snap = profiling.snapshot()
    return out, snap["counters"], snap["spans"]["gp_grief.gram"]["calls"]


def test_the_slab_path_counts_no_fused_apply():
    x, V = _data()
    k = _kern()
    _, counters, calls = _applies(tgr.make_gram_matvec(k, x, 0.3, chunk=128), V, k)
    assert counters.get("gram_fused_applies", 0) == 0 and counters.get("gram_fused_grads", 0) == 0 and calls == 3


def test_the_fused_branch_takes_the_solver_role_alone(monkeypatch):
    """With the predicate forced true: the solver apply goes to
    ``gram_apply`` and is the one apply counted in ``gram_fused_applies``;
    the differentiated apply takes ``GramApply`` (K9's forward, one K10 call
    counted in ``gram_fused_grads`` in its backward); bf16 state keeps the
    slab path."""
    x, V = _data()
    k = _kern()
    sig = torch.tensor(0.3, dtype=torch.float64)
    with torch.no_grad():
        slab = tgr.make_gram_matvec(k, x, sig, chunk=128)(V)
    monkeypatch.setattr(tgr, "fused_route", lambda *a: True)
    out, counters, calls = _applies(tgr.make_gram_matvec(k, x, sig, chunk=128), V, k)
    assert counters["gram_fused_applies"] == 1 and counters["gram_fused_grads"] == 1 and calls == 3
    assert float((out - slab).abs().max()) <= 1e-12 * float(slab.abs().max())
