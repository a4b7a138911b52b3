"""The port's ``GPRegression`` (the Cholesky path) against the JAX package's,
float64 on the CPU, on the same NumPy inputs (n = 200 in 2-D).

Both factorize the same ``(n, n)`` Gram, so the NLML, its gradient and the
predictions differ by rounding only: 1e-10 relative.  Twenty Adam steps are
the same update in both packages (``optimize.fit``): 1e-9 on the final NLML.
"""

import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.convert import params_from_jax

torch.set_num_threads(1)

TOL = 1e-10


def _data(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, y, rng.uniform(-1, 1, (30, 2))


def _kernels(pkg, kind):
    if kind == "one":
        return pkg.make_kernel("rbf", lengthscale=0.6, variance=1.3)
    return [pkg.make_kernel("rbf", lengthscale=0.5), pkg.make_kernel("matern52", lengthscale=0.7)]


def _pair(kind="one", **kw):
    x, y, xs = _data()
    jm = gpx.GPRegression(x, y, _kernels(gpx, kind), noise_var=0.3, **kw)
    tm = gpt.GPRegression(x, y, _kernels(gpt, kind), noise_var=0.3, device="cpu", **kw)
    return jm, tm, xs


def _jax_leaves(jm):
    return dict(zip(jm._param_leaf_names(), [np.asarray(v) for v in jax.tree_util.tree_leaves(jm.params)]))


KINDS = pytest.mark.parametrize("kind", ["one", "per_dimension"])


@KINDS
def test_nlml_and_gradient_match_jax(kind):
    jm, tm, _ = _pair(kind)
    assert tm._param_leaf_names() == jm._param_leaf_names()
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=TOL)
    gj = np.asarray(ravel_pytree(jax.grad(jm._loss)(jm.params))[0])
    tm.zero_grad()
    tm._loss().backward()
    gt = np.concatenate([p.grad.reshape(-1).numpy() for _, p in tm._leaves()])
    np.testing.assert_allclose(gt, gj, rtol=TOL, atol=TOL * np.abs(gj).max())
    assert tm.noise_var == pytest.approx(jm.noise_var, rel=1e-15)


@KINDS
@pytest.mark.parametrize("include_noise", [False, True])
def test_predict_matches_jax(kind, include_noise):
    jm, tm, xs = _pair(kind)
    mj, vj = jm.predict(xs, include_noise=include_noise)
    mt, vt = tm.predict(xs, include_noise=include_noise)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=0, atol=TOL * np.abs(mj).max())
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=TOL * np.abs(vj).max())
    assert bool((vt >= 0).all())
    np.testing.assert_array_equal(tm.predict(xs, compute_var=False).numpy(), mt.numpy())


def test_adam_steps_match_jax():
    jm, tm, xs = _pair("per_dimension")
    rj = jm.optimize(optimizer="adam", max_iters=20, learning_rate=0.05)
    rt = tm.optimize(optimizer="adam", max_iters=20, learning_rate=0.05)
    assert rt.iterations == rj.iterations == 20
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-9)
    # The cached factor follows the new parameters.
    np.testing.assert_allclose(tm.predict(xs, compute_var=False).numpy(), jm.predict(xs, compute_var=False),
                               rtol=1e-8, atol=1e-10)


@KINDS
def test_params_from_jax_round_trip(kind):
    jm, tm, _ = _pair(kind)
    jm.optimize(optimizer="adam", max_iters=5)
    tm.load_state_dict(params_from_jax(_jax_leaves(jm)))
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=TOL)
    with pytest.raises(KeyError):
        params_from_jax({"kernel.log_periods": np.zeros(())})


def test_iterative_path_raises_not_implemented():
    # The iterative path is ported (tests/test_torch_gp_iterative.py): it
    # builds, and the constructor keeps its options; only a bad solver raises.
    x, y, _ = _data()
    k = gpt.make_kernel("rbf")
    assert gpt.GPRegression(x, y, k, solver="iterative", device="cpu").solver == "iterative"
    assert gpt.GPRegression(x, y, k, matvec_chunk=64, device="cpu")._iter_opts["matvec_chunk"] == 64
    with pytest.raises(ValueError, match="solver"):
        gpt.GPRegression(x, y, k, solver="lu", device="cpu")
    m = gpt.GPRegression(x, y, k, num_probes=4, cg_tol=1e-6, mixed16=True, seed=7, device="cpu")
    assert m._iter_opts["num_probes"] == 4 and m._iter_opts["mixed16"] and m.seed == 7
    assert m._iter_opts["matvec_chunk"] == 0  # "auto" at n <= 32768: the dense Gram


def test_defaults_to_the_card(monkeypatch):
    x, y, _ = _data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.GPRegression(x, y, gpt.make_kernel("rbf"))
    assert gpt.GPRegression(torch.as_tensor(x), torch.as_tensor(y), gpt.make_kernel("rbf")).x.device.type == "cpu"
