"""``GPRegression``'s iterative path (CG + SLQ on the dense or matrix-free
Gram, pivoted-Cholesky whitening, BBMM training, matrix-free predict)
against the JAX package's, float64 on the CPU, on the same NumPy inputs.

The ``probes`` fixture hands both packages the same NumPy Rademacher probes
in call order (``tools/ski_reference_jax.NumpyProbes`` for
``jax.random.rademacher``, ``chip_smoke.NumpyProbes`` for the port's
``ops.lanczos.rademacher``).  The JAX package's segmented drivers draw each
probe chunk inside a compiled program, where a patched draw runs once per
chunk size, so the parity cases take one probe chunk.

Tolerances: the matrix-free operator, the slab and the pivoted Cholesky
are the same arithmetic (1e-12; the solver slab equals ``cov`` bit for
bit); NLMLs, gradients, trained parameters and predictions come from CGs
run to 1e-12 (1e-10 for training), so they differ by rounding and by where
CG stops: 1e-9 relative.  ``mixed16`` is held within 1e-3 of the plain
float32 NLML, as the JAX package's own test holds it
(``tests/test_iterative_gp.py:285``).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
import gp_grief_tpu_torch.ops.lanczos as tlz
import jax
import jax.numpy as jnp
from gp_grief_tpu.models import gp_regression as jgr
from gp_grief_tpu.ops import precond as jpc
from gp_grief_tpu_torch.models import gp_regression as tgr
from gp_grief_tpu_torch.ops import precond as tpc
from tools import ski_reference_jax as ref

torch.set_num_threads(1)

TOL = 1e-12
RTOL = 1e-9
N, CHUNK = 300, 128
ITER = dict(num_probes=4, lanczos_iters=10, cg_tol=1e-12, cg_iters=400)


@pytest.fixture
def probes(monkeypatch):
    jp, tp = ref.NumpyProbes(), cs.NumpyProbes()
    monkeypatch.setattr(jax.random, "rademacher", jp)
    monkeypatch.setattr(tlz, "rademacher", tp)
    return jp, tp


def _data(n=N, seed=0, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 4, (n, d))
    y = np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, y, rng.uniform(0, 4, (20, d))


def _kern(pkg, **kw):
    return pkg.make_kernel("rbf", lengthscale=0.8, input_dim=2, **kw)


def _pair(n=N, **kw):
    x, y, xs = _data(n)
    opts = dict(noise_var=0.3, solver="iterative", **kw)
    return gpx.GPRegression(x, y, _kern(gpx), **opts), gpt.GPRegression(x, y, _kern(gpt), device="cpu", **opts), xs


def _flat_grad(tm):
    tm.zero_grad()
    loss = tm._loss()
    loss.backward()
    return float(loss.detach()), np.concatenate([p.grad.reshape(-1).numpy() for _, p in tm._leaves()])


def _close(a, b, tol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("n,chunk", [(600, 128), (8200, 2100)], ids=["broadcast", "matmul"])
def test_gram_matvec_matches_jax(n, chunk):
    rng = np.random.default_rng(1)
    x, V = rng.uniform(0, 8, (n, 2)), rng.standard_normal((3, n))
    assert n % chunk and (chunk * n > 1 << 24) == (n == 8200)  # a padded last block; both distance regimes
    want = np.asarray(jgr.make_gram_matvec(_kern(gpx), jnp.asarray(x), 0.3, chunk=chunk)(jnp.asarray(V)))
    mv = tgr.make_gram_matvec(_kern(gpt), torch.as_tensor(x), torch.tensor(0.3, dtype=torch.float64), chunk=chunk)
    with torch.no_grad():
        got = mv(torch.as_tensor(V))
    _close(got.numpy(), want, TOL)
    if n == 600:  # the differentiated (checkpointed) operator gives the same values
        np.testing.assert_array_equal(mv(torch.as_tensor(V)).detach().numpy(), got.numpy())


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_solver_slab_keeps_cov_bits(kind, dtype):
    # d = 5 takes _sq_dist's matmul regime at any size, as chunk·n > 2^24 does.
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0, 4, (300, 5)), dtype=dtype)
    k = gpt.make_kernel(kind, lengthscale=0.9, variance=1.3, input_dim=5, dtype=dtype)
    k2 = gpt.make_kernel(kind, lengthscale=0.9, variance=1.3, dtype=dtype)
    with torch.no_grad():
        assert torch.equal(tgr._solver_slab(k, x[:64], x), k(x[:64], x))
        assert torch.equal(tgr._solver_slab(k2, x[:64, :2], x[:, :2]), k2(x[:64, :2], x[:, :2]))  # broadcast


def test_fast_operator_is_the_exact_one_in_bf16():
    x, _, _ = _data(400)
    V = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 400)))
    args = (_kern(gpt), torch.as_tensor(x), torch.tensor(0.3, dtype=torch.float64))
    with torch.no_grad():
        exact = tgr.make_gram_matvec(*args, chunk=CHUNK)(V)
        fast = tgr.make_gram_matvec(*args, chunk=CHUNK, precision="default")(V)
    assert fast.dtype == torch.float64
    assert 0 < float((fast - exact).abs().max() / exact.abs().max()) < 2e-2
    with pytest.raises(ValueError, match="precision"):
        tgr.make_gram_matvec(*args, chunk=CHUNK, precision="low")


@pytest.mark.parametrize("where", ["dense", "matfree"])
def test_pivoted_cholesky_matches_jax(where):
    x, _, _ = _data()
    K = np.asarray(jgr._cov_any(_kern(gpx), jnp.asarray(x)))
    if where == "dense":
        want = jpc.pivoted_cholesky(jnp.asarray(K), 16)
        got = tpc.pivoted_cholesky(torch.as_tensor(K), 16)
    else:
        want = jpc.pivoted_cholesky_matfree(jgr._gram_row_fn(_kern(gpx), jnp.asarray(x)), jnp.diagonal(K), 16)
        with torch.no_grad():
            got = tpc.pivoted_cholesky_matfree(tgr._gram_row_fn(_kern(gpt), torch.as_tensor(x)),
                                               torch.as_tensor(np.diag(K).copy()), 16)
    assert got.shape == (N, 16)
    _close(got.numpy(), np.asarray(want), TOL)


def test_pivoted_cholesky_past_the_numerical_rank():
    # Three clusters of exact duplicates, too far apart for the kernel to
    # couple them: rank 3, so columns 3.. are exactly zero (an exhausted
    # diagonal), and step 0's tied diagonal picks index 0, as jnp.argmax does.
    x = np.repeat(np.array([[0.0, 0.0], [60.0, 0.0], [0.0, 60.0]]), [4, 5, 3], axis=0)
    K = np.asarray(jgr._cov_any(_kern(gpx), jnp.asarray(x)))
    want = np.asarray(jpc.pivoted_cholesky(jnp.asarray(K), 7))
    got = tpc.pivoted_cholesky(torch.as_tensor(K), 7).numpy()
    _close(got, want, TOL)
    assert np.all(got[:, 3:] == 0) and got[0, 0] > 0
    _close(got @ got.T, K, TOL)


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["dense", "matfree"])
@pytest.mark.parametrize("rank", [0, 16])
def test_nlml_iterative_value_and_gradient_match_jax(probes, chunk, rank):
    jm, tm, _ = _pair(matvec_chunk=chunk, precond_rank=rank, **ITER)
    vj, gj = jax.value_and_grad(jm._loss)(jm.params)
    vt, gt = _flat_grad(tm)
    assert probes[0].calls == probes[1].calls == 2  # z, then SLQ's probes
    assert vt == pytest.approx(float(vj), rel=RTOL)
    _close(gt, np.asarray(jax.flatten_util.ravel_pytree(gj)[0]), RTOL)
    # Without a gradient no surrogate is built: the value alone.
    probes[1].calls = 0
    assert tm.log_likelihood() == pytest.approx(-vt, rel=1e-14)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "separate"])
def test_segmented_nlml_matches_jax(probes, fuse):
    jm, tm, _ = _pair(matvec_chunk=CHUNK, precond_rank=16, **ITER)
    kw = dict(cg_segment_iters=10, probe_chunk=4, fuse_probes=fuse)
    want = jm.log_likelihood_iterative_segmented(**kw)
    got = tm.log_likelihood_iterative_segmented(**kw)
    assert probes[0].calls == probes[1].calls == 1
    assert got == pytest.approx(want, rel=RTOL)
    assert tm.cg_iterations > 0


def test_mixed16_segmented_nlml_matches_plain():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(600, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(600)).astype(np.float32)
    # The JAX test's data at 8 probes, a float32-reachable tolerance, and a
    # bound on the refinement's restarts.
    kw = dict(noise_var=0.05, solver="iterative", matvec_chunk=128, num_probes=8, lanczos_iters=24, cg_tol=1e-6,
              cg_iters=200, device="cpu")
    m_mixed = gpt.GPRegression(x, y, gpt.make_kernel("rbf", lengthscale=0.7, input_dim=2), mixed16=True, **kw)
    m_plain = gpt.GPRegression(x, y, gpt.make_kernel("rbf", lengthscale=0.7, input_dim=2), **kw)
    ll_m, ll_p = m_mixed.log_likelihood_iterative_segmented(), m_plain.log_likelihood_iterative_segmented()
    assert np.isfinite(ll_m) and abs(ll_m - ll_p) < 1e-3 * abs(ll_p)
    assert abs(m_mixed.log_likelihood() - m_plain.log_likelihood()) < 1e-2 * abs(ll_p)  # the monolithic loss
    with pytest.warns(UserWarning, match="mixed16_slq"):
        m_mixed.log_likelihood_iterative_segmented(mixed16_slq=True, fuse_probes=True, num_probes=2, lanczos_iters=4)
    with pytest.raises(TypeError, match="unknown iterative options"):
        m_plain.log_likelihood_iterative_segmented(num_probe=4)


TRAIN = dict(matvec_chunk=CHUNK, precond_rank=16, num_probes=4, lanczos_iters=8, cg_tol=1e-10, cg_iters=300)


def test_optimize_segmented_matches_jax(probes):
    jm, tm, _ = _pair(**TRAIN)
    jm.optimize_segmented(max_iters=3, learning_rate=0.05, cg_segment_iters=10)
    res = tm.optimize_segmented(max_iters=3, learning_rate=0.05, cg_segment_iters=10)
    assert probes[0].calls == probes[1].calls == 1  # one probe draw for the run
    _close(tm.parameters, jm.parameters, RTOL)
    assert res.iterations == 3 and np.all(np.isfinite(res.losses)) and np.all(res.grad_norms > 0)


def test_optimize_segmented_tracks_the_monolithic_loss():
    # The JAX package's invariant (tests/test_iterative_gp.py:390): the
    # monolithic loss draws its z from the same seeded generator as
    # optimize_segmented's probes, so both take the same Adam steps.
    x, y, _ = _data()
    seg, mono = (gpt.GPRegression(x, y, _kern(gpt), noise_var=0.3, solver="iterative", device="cpu", **TRAIN)
                 for _ in range(2))
    seg.optimize_segmented(max_iters=3, learning_rate=0.05, cg_segment_iters=10)
    mono.optimize(optimizer="adam", max_iters=3, learning_rate=0.05, tol=0.0)
    _close(seg.parameters, mono.parameters, RTOL)
    dense = gpt.GPRegression(x, y, _kern(gpt), noise_var=0.3, solver="iterative", device="cpu")
    with pytest.raises(ValueError, match="matrix-free"):
        dense.optimize_segmented(max_iters=1)


def test_predict_iterative_matches_jax_and_cholesky(monkeypatch):
    jm, tm, xs = _pair(matvec_chunk=CHUNK, precond_rank=16, cg_tol=1e-12, cg_iters=400)
    mj, vj = jm.predict(xs, include_noise=True, chunk=8)
    mt, vt = tm.predict(xs, include_noise=True, chunk=8)  # 20 points: a ragged last chunk
    _close(mt.numpy(), mj, RTOL)
    _close(vt.numpy(), vj, RTOL)
    chol = gpt.GPRegression(*_data()[:2], _kern(gpt), noise_var=0.3, device="cpu")
    mc, vc = chol.predict(xs, include_noise=True)
    _close(mt.numpy(), mc.numpy(), 1e-8)
    _close(vt.numpy(), vc.numpy(), 1e-8)
    # A second call at the same parameters makes no α solve.
    calls = []
    solve = tgr.cg_segments
    monkeypatch.setattr(tgr, "cg_segments", lambda *a, **k: calls.append(a[1].shape) or solve(*a, **k))
    np.testing.assert_array_equal(tm.predict(xs, compute_var=False).numpy(), mt.numpy())
    assert calls == []
    assert tm.predict(xs[:0], compute_var=False).shape == (0,)


def test_matrix_free_gradient_saves_no_gram():
    # The counterpart of the JAX package's HLO check
    # (tests/test_iterative_gp.py:312): autograd of the matrix-free loss
    # keeps no (n, n)-sized tensor, nor one block's (chunk, n) slab.
    n, chunk = 512, 128
    x, y, _ = _data(n)
    tm = gpt.GPRegression(x, y, _kern(gpt), noise_var=0.3, solver="iterative", matvec_chunk=chunk,
                          precond_rank=16, num_probes=8, lanczos_iters=8, cg_tol=1e-6, cg_iters=40, device="cpu")
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tm._loss()
    loss.backward()
    assert saved and max(saved) < chunk * n and sum(saved) < n * n // 4
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for _, p in tm._leaves())


@pytest.mark.parametrize("chunk", [0, "auto", 96])
def test_iterative_model_runs_at_every_chunk_setting(chunk):
    x, y, xs = _data(200)
    tm = gpt.GPRegression(x, y, _kern(gpt), noise_var=0.3, solver="iterative", matvec_chunk=chunk,
                          precond_rank=8, num_probes=8, lanczos_iters=20, device="cpu")
    assert tm._iter_opts["matvec_chunk"] == (96 if chunk == 96 else 0)  # "auto": the dense Gram at n ≤ 32768
    exact = gpt.GPRegression(x, y, _kern(gpt), noise_var=0.3, device="cpu").log_likelihood()
    assert abs(tm.log_likelihood() - exact) < 5.0  # SLQ's sampling error, a few nats at this n
    mean, var = tm.predict(xs)
    assert mean.shape == var.shape == (20,) and bool((var >= 0).all())
