"""Parity of the port's GPGriefModel, fit loop and conversion helpers against
the JAX package, in float64 on the CPU.

NLML, gradients and predictions do not depend on eigenvector signs, so the
two packages' independently built bases compare directly.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.convert import params_from_jax
from gp_grief_tpu_torch.optimize import fit

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _data(n=240, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.3 * x[:, -1] + 0.1 * rng.standard_normal(n)
    xs = rng.uniform(-1, 1, (50, d))
    return x, y, xs


def _pair(opt_kernel_params=False, *, n_eigs=20, shared=False, chunk=None, **kw):
    x, y, xs = _data()
    if shared:
        jk, tk = gpx.make_kernel("rbf", lengthscale=0.6), gpt.make_kernel("rbf", lengthscale=0.6)
    else:
        kinds = ["rbf", "matern52", "rbf"]
        jk = [gpx.make_kernel(k, lengthscale=0.5 + 0.1 * i) for i, k in enumerate(kinds)]
        tk = [gpt.make_kernel(k, lengthscale=0.5 + 0.1 * i) for i, k in enumerate(kinds)]
    common = dict(n_eigs=n_eigs, noise_var=0.3, opt_kernel_params=opt_kernel_params, dim_noise_var=1e-6, **kw)
    jm = gpx.GPGriefModel(x, y, jk, gpx.InducingGrid.build(x, mbar=7), **common)
    tm = gpt.GPGriefModel(x, y, tk, gpt.InducingGrid.build(x, mbar=7), dtype=torch.float64, device="cpu", **common)
    if chunk is not None:
        jm.stats_chunk = tm.stats_chunk = chunk
        if not opt_kernel_params:
            jm._refresh_cache()
            tm._refresh_cache()
    return jm, tm, xs


def _jax_leaves(jm):
    return dict(zip(jm._param_leaf_names(), [np.asarray(l) for l in jax.tree_util.tree_leaves(jm.params)]))


def _grads(tm):
    tm.zero_grad()
    tm._loss().backward()
    return np.concatenate([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).numpy() for _, p in tm._leaves()
    ])


@pytest.mark.parametrize("opt_kernel_params", [False, True], ids=["reweight", "kernel_params"])
def test_nlml_and_gradient_match_jax(opt_kernel_params):
    jm, tm, _ = _pair(opt_kernel_params)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-12)
    gj = np.asarray(jax.flatten_util.ravel_pytree(jax.jit(jax.grad(jm._loss))(jm.params))[0])
    np.testing.assert_allclose(_grads(tm), gj, rtol=1e-9, atol=1e-9 * np.abs(gj).max())


@pytest.mark.parametrize("opt_kernel_params", [False, True], ids=["reweight", "kernel_params"])
def test_adam_steps_match_optax(opt_kernel_params):
    jm, tm, _ = _pair(opt_kernel_params)
    rj = jm.optimize(optimizer="adam", max_iters=20, learning_rate=0.05)
    rt = tm.optimize(optimizer="adam", max_iters=20, learning_rate=0.05)
    np.testing.assert_allclose(tm.parameters, jm.parameters, rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-10)
    assert rt.iterations == rj.iterations == 20


def test_adam_resume_from_opt_state():
    _, tm, _ = _pair()
    _, tm2, _ = _pair()
    tm.optimize(optimizer="adam", max_iters=10)
    r = tm2.optimize(optimizer="adam", max_iters=4)
    tm2.optimize(optimizer="adam", max_iters=6, opt_state=r.opt_state)
    np.testing.assert_allclose(tm2.parameters, tm.parameters, rtol=0, atol=1e-13)


def test_lbfgs_converged_nlml_matches():
    """optax and torch L-BFGS search lines differently: hold the optimum."""
    jm, tm, _ = _pair(n_eigs=10)
    jm.optimize(max_iters=80, tol=1e-9)  # both within ~1e-9 of the optimum by then
    tm.optimize(max_iters=80, tol=1e-9)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-6)


@pytest.mark.parametrize("chunk", [None, 64], ids=["one_block", "row_chunked"])
def test_predict_matches_jax(chunk):
    jm, tm, xs = _pair(chunk=chunk)
    jm.optimize(optimizer="adam", max_iters=5)
    tm.optimize(optimizer="adam", max_iters=5)
    mj, vj = jm.predict(xs, include_noise=True)
    mt, vt = tm.predict(xs, include_noise=True)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tm.predict(xs, compute_var=False).numpy(), mj, rtol=1e-9, atol=1e-11)
    v = np.random.default_rng(0).standard_normal(240)
    np.testing.assert_allclose(tm.kernel_matvec(torch.as_tensor(v)).numpy(),
                               np.asarray(jm.kernel_matvec(jax.numpy.asarray(v))), rtol=1e-10)


def test_row_chunked_stats_match_one_block():
    """The stats_chunk branch (exercised at n > stats_chunk) in both regimes."""
    for opt in (False, True):
        _, one, _ = _pair(opt)
        jm, chunked, _ = _pair(opt, chunk=64)
        assert chunked.log_likelihood() == pytest.approx(one.log_likelihood(), rel=1e-12)
        assert chunked.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-12)


def test_parameters_round_trip_and_state_dict_names():
    jm, tm, _ = _pair()
    assert list(tm.state_dict()) != [] and set(tm.state_dict()) == set(jm._param_leaf_names())
    assert tm._param_leaf_names() == jm._param_leaf_names()
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    jm.optimize(optimizer="adam", max_iters=5)
    tm.parameters = jm.parameters  # flat vector from one package into the other
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-12)
    with pytest.raises(ValueError, match="expected"):
        tm.parameters = jm.parameters[:-1]


def test_params_from_jax():
    jm, tm, _ = _pair(True)
    jm.optimize(optimizer="adam", max_iters=5)
    tm.load_state_dict(params_from_jax(_jax_leaves(jm)))
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-12)
    with pytest.raises(KeyError):
        params_from_jax({"kernels.0.bogus": np.zeros(())})


def test_fix_free_match_jax():
    jm, tm, _ = _pair(True)
    for m in (jm, tm):
        m.fix("log_lengthscale", "kernels.1.log_variance")
    assert tm.fixed_parameters == jm.fixed_parameters
    ls0 = [float(k.log_lengthscale.detach()) for k in tm.kernels]
    jm.optimize(optimizer="adam", max_iters=5)
    tm.optimize(optimizer="adam", max_iters=5)
    assert [float(k.log_lengthscale.detach()) for k in tm.kernels] == ls0
    np.testing.assert_allclose(tm.parameters, jm.parameters, rtol=0, atol=1e-8)
    tm.free("log_lengthscale")
    assert tm.fixed_parameters == ["kernels.1.log_variance"]
    tm.free()
    assert tm.fixed_parameters == []
    with pytest.raises(ValueError, match="matches no parameter"):
        tm.fix("log_typo")


def test_shared_kernel_becomes_independent_modules():
    """One kernel passed in radial mode: d independent parameter sets (as the
    JAX pytree's d leaves), which train apart."""
    jm, tm, _ = _pair(True, shared=True)
    ids = {id(k.log_lengthscale) for k in tm.kernels}
    assert len(tm.kernels) == 3 and len(ids) == 3
    jm.optimize(optimizer="adam", max_iters=8)
    tm.optimize(optimizer="adam", max_iters=8)
    np.testing.assert_allclose(tm.parameters, jm.parameters, rtol=0, atol=1e-8)
    assert len({float(k.log_lengthscale.detach()) for k in tm.kernels}) == 3


def test_cache_rebuilds_after_in_place_mutation():
    _, tm, _ = _pair()
    ll0 = tm.log_likelihood()
    with torch.no_grad():
        tm.kernels[0].log_lengthscale.add_(0.3)
    ll1 = tm.log_likelihood()
    _, fresh, _ = _pair()
    with torch.no_grad():
        fresh.kernels[0].log_lengthscale.add_(0.3)
    fresh.refresh_basis()
    assert ll1 != ll0 and ll1 == pytest.approx(fresh.log_likelihood(), rel=1e-13)


def test_fit_rejects_non_finite_step():
    """A non-finite loss stops the fit at the last good parameters and
    optimizer state."""
    for optimizer in ("adam", "lbfgs"):
        p = torch.nn.Parameter(torch.tensor([1.0, -2.0], dtype=torch.float64))
        calls = []

        def loss():
            calls.append(1)
            val = torch.sum((p - 0.5) ** 2)
            return val if len(calls) < 4 else val * torch.nan

        res = fit(loss, [("p", p)], optimizer=optimizer, max_iters=50, learning_rate=0.1)
        assert res.iterations >= 1 and bool(torch.isfinite(p).all())
        assert np.isfinite(res.losses).all() and res.iterations == len(res.losses) < 50


def test_checkgrad_and_input_validation():
    _, tm, _ = _pair(True)
    assert tm.checkgrad(sample=12)
    x, y, _ = _data()
    with pytest.raises(ValueError, match="one response per row"):
        gpt.GPGriefModel(x, y[:-1], gpt.make_kernel("rbf"), mbar=5, device="cpu")
    with pytest.raises(ValueError, match="need 3 kernels"):
        gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf")] * 2, mbar=5, device="cpu")
    m = gpt.GPGriefModel(x.astype(np.float32), y.astype(np.float32), gpt.make_kernel("rbf"), mbar=5,
                         n_eigs=10**6, device="cpu")
    assert m.x.dtype == torch.float32 and m.n_eigs == 125 and m.log_w.shape == (125,)


def test_models_default_to_the_card(monkeypatch):
    """Built from NumPy with no ``device``, a model goes to the card; with no
    card it raises instead of running on the CPU.  A tensor keeps its device."""
    x, y, _ = _data()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.GPGriefModel(x, y, gpt.make_kernel("rbf"), mbar=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.GPKroneckerRegression([np.linspace(0, 1, 4)[:, None]] * 2, np.zeros(16), gpt.make_kernel("rbf"))
    m = gpt.GPGriefModel(torch.as_tensor(x), torch.as_tensor(y), gpt.make_kernel("rbf"), mbar=5)
    assert m.x.device.type == "cpu"


def test_port_imports_without_jax():
    # Every module of the port, not only what the package root imports.
    code = (
        "import sys, importlib, pkgutil; sys.path.insert(0, sys.argv[1]); import gp_grief_tpu_torch as p; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
        "assert 'jax' not in sys.modules and 'gp_grief_tpu' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith(('jax', 'gp_grief_tpu.')))"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("chunk", [1000, 64], ids=["one_block", "row_chunked"])
def test_basis_stats_from_phi_matches_jax(chunk):
    from gp_grief_tpu.models.base import basis_stats_from_phi as j_stats
    from gp_grief_tpu_torch.models.base import basis_stats_from_phi as t_stats

    rng = np.random.default_rng(7)
    Phi, y = rng.standard_normal((300, 12)), rng.standard_normal(300)
    sj = j_stats(jax.numpy.asarray(Phi), jax.numpy.asarray(y), chunk=chunk)
    st = t_stats(torch.as_tensor(Phi), torch.as_tensor(y), chunk=chunk)
    for a, b in zip(st[:3], sj[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    assert st.n == sj.n == 300
