"""Parity of the port's GPKroneckerRegression against the JAX package, in
float64 on the CPU: NLML for every solver path, the segmented NLML, chunked
predict, Adam training with the closed-form (schur) solver, and parameter
conversion."""

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


def _grad(model):
    model.zero_grad()
    model._loss().backward()
    return np.concatenate([p.grad.numpy().ravel() for _, p in model._leaves()])


@pytest.mark.parametrize("solver", [s for s in _SOLVERS if s != "schur"])
def test_cg_gradient_matches_jax_and_schur(solver):
    """The CG implicit gradient against ``jax.grad`` of the JAX package's
    ``_loss`` (its ``custom_linear_solve``) and against the port's own schur
    gradient.  Exact CG stops at 1e-10 relative residual: measured ≤ 1.9e-13
    from JAX's and ≤ 5.7e-12 from schur's, held at 1e-10.  Refinement stops
    at its floor of 1e-8: measured ≤ 1.3e-8 (mixed16's bf16 inner state lands
    each package on its own iterate), held at 1e-7."""
    jm, tm, _ = _pair(**_SOLVERS[solver])
    got = _grad(tm)
    want = np.concatenate([np.ravel(g) for g in jax.tree_util.tree_leaves(jax.grad(jm._loss)(jm.params))])
    schur = _grad(_pair(solver="schur")[1])
    rtol = 1e-7 if "mixed" in solver else 1e-10
    for ref in (want, schur):
        assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_cg_adam_steps_match_jax():
    """``optimize`` with the deflated, whitened CG solver: three Adam steps
    through the implicit gradient, held to the JAX package's trajectory."""
    jm, tm, _ = _pair(**_SOLVERS["cg_deflated_whitened"])
    rj = jm.optimize(optimizer="adam", max_iters=3, learning_rate=0.05)
    rt = tm.optimize(optimizer="adam", max_iters=3, learning_rate=0.05)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-10)
    np.testing.assert_allclose(tm.parameters, jm.parameters, rtol=0, atol=1e-9)
    assert rt.losses[-1] < rt.losses[0] and tm.cg_info.iterations > 0


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
    assert math.isfinite(cg.log_likelihood_segmented())
    # mesh= is ported (tests/test_torch_parallel.py); the schur solver refuses it, as in the JAX package.
    mesh = gpt.parallel.make_mesh((1,), ("model",), device_type="cpu")
    with pytest.raises(ValueError, match="mesh"):
        gpt.GPKroneckerRegression(xg, y, k, solver="schur", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="one response per grid point"):
        gpt.GPKroneckerRegression(xg, y[:-1], k, device="cpu")
    with pytest.raises(ValueError, match="columns"):
        cg.predict(np.zeros((3, 5)))
    with pytest.raises(ValueError, match="dims"):
        gpt.GPKroneckerRegression(xg, y, k, dims=[(0,), (0,), (1,)], device="cpu")


def _segmented_pair(**kw):
    """tests/test_models.py:540-580's model in both packages."""
    gs = [np.linspace(0, 1, 7)[:, None], np.linspace(0, 2, 6)[:, None]]
    yg = np.random.default_rng(0).standard_normal(42)
    common = dict(noise_var=0.3, solver="cg", cg_tol=1e-12, cg_iters=300, **kw)
    kinds = [("rbf", 0.4), ("matern32", 0.7)]
    jm = gpx.GPKroneckerRegression(gs, yg, [gpx.make_kernel(k, lengthscale=ls) for k, ls in kinds], **common)
    tm = gpt.GPKroneckerRegression(gs, yg, [gpt.make_kernel(k, lengthscale=ls) for k, ls in kinds], device="cpu",
                                   **common)
    return jm, tm


@pytest.mark.parametrize("kw", [dict(precond_rank=0), dict(precond_rank=12),
                                dict(precond_rank=12, cg_whiten=True)], ids=["r0", "r12", "r12_whitened"])
def test_log_likelihood_segmented_matches_jax(kw, capsys):
    """The segmented NLML (closed log-det, CG quadratic term in host
    segments): against the JAX package's at 1e-10, against the port's own
    CG NLML at 1e-8, repeats bit for bit; ``verbose`` prints a line per
    segment."""
    jm, tm = _segmented_pair(**kw)
    want = jm.log_likelihood_segmented(cg_segment_iters=20)
    got = tm.log_likelihood_segmented(cg_segment_iters=20, verbose=True)
    assert abs(got - want) <= 1e-10 * abs(want)
    assert abs(got - tm.log_likelihood()) <= 1e-8 * abs(got)
    assert tm.log_likelihood_segmented(cg_segment_iters=20) == got
    assert tm.cg_iterations % 20 == 0 and 0 < tm.cg_iterations < 300
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == tm.cg_iterations // 20 and lines[0].startswith("[cg_segments] segment 1: iters=20")
