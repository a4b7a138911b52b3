"""Parity of the port's GPKroneckerRegression against the JAX package, in
float64 on the CPU: NLML for every solver path, chunked predict, Adam
training with the closed-form (schur) solver, and parameter conversion."""

import math

import numpy as np
import pytest
import torch

import jax

import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.convert import params_from_jax

torch.set_num_threads(1)

SIZES = (6, 7, 8)


def _data(sub_dim=False, seed=0):
    rng = np.random.default_rng(seed)
    xg = [np.sort(rng.uniform(0, 3, m))[:, None] for m in SIZES]
    if sub_dim:  # the middle grid dimension groups two input columns
        xg[1] = rng.uniform(0, 3, (SIZES[1], 2))
    y = rng.standard_normal(math.prod(SIZES))
    n_cols = sum(g.shape[1] for g in xg)
    xs = rng.uniform(0, 3, (41, n_cols))
    return xg, y, xs


def _pair(sub_dim=False, **kw):
    xg, y, xs = _data(sub_dim)
    kinds = ["rbf", "matern52", "rbf"]
    jk = [gpx.make_kernel(k, lengthscale=0.5 + 0.1 * i) for i, k in enumerate(kinds)]
    tk = [gpt.make_kernel(k, lengthscale=0.5 + 0.1 * i) for i, k in enumerate(kinds)]
    common = dict(noise_var=0.3, **kw)
    return gpx.GPKroneckerRegression(xg, y, jk, **common), gpt.GPKroneckerRegression(xg, y, tk, device="cpu", **common), xs


_SOLVERS = {
    "schur": dict(solver="schur"),
    "cg_exact": dict(solver="cg", cg_tol=1e-10),
    "cg_deflated": dict(solver="cg", cg_tol=1e-10, precond_rank=24),
    "cg_deflated_whitened": dict(solver="cg", cg_tol=1e-10, precond_rank=24, cg_whiten=True),
    "cg_mixed": dict(solver="cg", cg_tol=1e-8, cg_precision="mixed"),
    "cg_mixed16": dict(solver="cg", cg_tol=1e-8, cg_precision="mixed16", cg_iters=400),
}


@pytest.mark.parametrize("sub_dim", [False, True], ids=["lattice", "sub_dim"])
@pytest.mark.parametrize("solver", list(_SOLVERS))
def test_nlml_matches_jax(solver, sub_dim):
    """The closed form agrees to ~1e-13.  Exact CG solves to 1e-10 relative
    residual, so the NLML agrees to ~1e-9.  Refinement stops at its floor of
    1e-7 relative residual, and mixed16's bf16 inner state lands each
    package on a different iterate within it: 1e-8."""
    jm, tm, _ = _pair(sub_dim, **_SOLVERS[solver])
    want = jm.log_likelihood()
    got = tm.log_likelihood()
    rel = 1e-13 if solver == "schur" else 1e-8 if "mixed" in solver else 1e-9
    assert got == pytest.approx(want, rel=rel)
    if solver != "schur":
        assert tm.cg_info is not None and tm.cg_info.fallback_iterations == 0


@pytest.mark.parametrize("sub_dim", [False, True], ids=["lattice", "sub_dim"])
@pytest.mark.parametrize("chunk", [0, 7], ids=["auto_chunk", "chunk7"])
def test_predict_matches_jax(chunk, sub_dim):
    jm, tm, xs = _pair(sub_dim)
    mj, vj = jm.predict(xs, include_noise=True, chunk=chunk)
    mt, vt = tm.predict(xs, include_noise=True, chunk=chunk)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tm.predict(xs, compute_var=False, chunk=chunk).numpy(), mj, rtol=1e-10, atol=1e-12)
    assert bool((vt > 0).all())


def test_adam_steps_with_schur_match_jax():
    jm, tm, _ = _pair()
    rj = jm.optimize(optimizer="adam", max_iters=10, learning_rate=0.05)
    rt = tm.optimize(optimizer="adam", max_iters=10, learning_rate=0.05)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-10)
    np.testing.assert_allclose(tm.parameters, jm.parameters, rtol=0, atol=1e-9)
    assert rt.iterations == rj.iterations == 10


def test_params_from_jax_round_trip():
    jm, tm, xs = _pair()
    jm.optimize(optimizer="adam", max_iters=5, learning_rate=0.05)
    leaves = dict(zip(jm._param_leaf_names(), [np.asarray(v) for v in jax.tree_util.tree_leaves(jm.params)]))
    assert sorted(leaves) == sorted(tm.state_dict())
    tm.load_state_dict(params_from_jax(leaves))
    np.testing.assert_allclose(tm.parameters, jm.parameters, rtol=0, atol=0)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-13)


def test_unported_surfaces_raise():
    xg, y, _ = _data()
    k = gpt.make_kernel("rbf")
    cg = gpt.GPKroneckerRegression(xg, y, k, solver="cg", device="cpu")
    with pytest.raises(NotImplementedError, match="solver='cg'"):
        cg.optimize(max_iters=2)
    with pytest.raises(NotImplementedError, match="gradient"):
        cg._loss()
    with pytest.raises(NotImplementedError, match="not ported"):
        cg.log_likelihood_segmented()
    with pytest.raises(NotImplementedError, match="mesh"):
        gpt.GPKroneckerRegression(xg, y, k, solver="cg", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="one response per grid point"):
        gpt.GPKroneckerRegression(xg, y[:-1], k, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        cg.predict(np.zeros((3, 5)))
    with pytest.raises(ValueError, match="dims"):
        gpt.GPKroneckerRegression(xg, y, k, dims=[(0,), (0,), (1,)], device="cpu")
