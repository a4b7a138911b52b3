"""Parity of the port's GPweb against the JAX package's, in float64 on the
CPU (tests/test_models.py:171-195's cases), and against the port's own
GPGriefModel on the same basis."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
from gp_grief_tpu.kernels import build_basis as jbuild_basis
from gp_grief_tpu.kernels import phi as jphi
from gp_grief_tpu_torch.convert import params_from_jax
from gp_grief_tpu_torch.kernels.grief import phi as tphi
from gp_grief_tpu_torch.models import gp_web

torch.set_num_threads(1)

ADAM = dict(optimizer="adam", max_iters=40, learning_rate=0.05)


def _sine_basis(n=60, p=10, n_test=25):
    """The JAX test's data and GRIEF basis: Φ on the training points and Φ*
    on test points, from the JAX package, as NumPy arrays."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(n, 1))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    grid = gpx.InducingGrid.build(x, mbar=15)
    kerns = [gpx.make_kernel("rbf", lengthscale=0.5)]
    xg = [jnp.asarray(g) for g in grid.xg]
    basis = jbuild_basis(kerns, xg, p)
    xs = np.linspace(0, 4, n_test)[:, None]
    return x, y, grid, np.asarray(jphi(basis, kerns, xg, jnp.asarray(x))), np.asarray(
        jphi(basis, kerns, xg, jnp.asarray(xs)))


def test_gp_web_matches_jax():
    """NLML and its gradient at the start, 40 Adam steps and predict: rounding
    only, measured 2.5e-14 (NLML), 2.6e-13 (the trace), 4.4e-15 (the
    parameters) and ≤ 4.8e-15 of the scale (mean, variance)."""
    _, y, _, Phi, Phis = _sine_basis()
    jw = gpx.GPweb(Phi, y, noise_var=0.1)
    tw = gpt.GPweb(Phi, y, noise_var=0.1, device="cpu")
    assert tw.stats.C.device.type == "cpu" and tw.p == 10
    assert sorted(tw.state_dict()) == sorted(jw._param_leaf_names()) == ["log_noise", "log_w"]
    assert tw.log_likelihood() == pytest.approx(jw.log_likelihood(), rel=1e-12)
    np.testing.assert_allclose(tw.parameters, jw.parameters, rtol=0, atol=0)
    assert tw.checkgrad()
    rj = jw.optimize(**ADAM)
    rt = tw.optimize(**ADAM)
    assert rt.iterations == rj.iterations == 40 and rt.losses[-1] < rt.losses[0]
    np.testing.assert_allclose(rt.losses, rj.losses, rtol=1e-9)
    np.testing.assert_allclose(tw.parameters, jw.parameters, rtol=1e-9, atol=1e-9)
    assert tw.log_likelihood() == pytest.approx(jw.log_likelihood(), rel=1e-9)
    mean_j, var_j = jw.predict(Phis)
    mean_t, var_t = tw.predict(Phis)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, rtol=1e-10, atol=1e-10 * np.abs(mean_j).max())
    np.testing.assert_allclose(var_t.numpy(), var_j, rtol=1e-10, atol=1e-10 * np.abs(var_j).max())
    mean_n, var_n = tw.predict(Phis, include_noise=True)
    np.testing.assert_array_equal(var_n.numpy(), (var_t + torch.exp(tw.log_noise.detach())).numpy())
    np.testing.assert_array_equal(tw.predict(Phis, compute_var=False).numpy(), mean_t.numpy())
    # JAX's parameters load into the port under the same names.
    leaves = {"log_noise": np.asarray(jw.params["log_noise"]), "log_w": np.asarray(jw.params["log_w"])}
    fresh = gpt.GPweb(Phi, y, noise_var=0.1, device="cpu")
    fresh.load_state_dict(params_from_jax(leaves))
    assert fresh.log_likelihood() == pytest.approx(jw.log_likelihood(), rel=1e-12)


def test_gp_web_equals_grief_on_the_same_basis():
    """GPweb over the port's own GRIEF Φ is the GRIEF model in reweight mode:
    the same statistics, NLML, training and predictions, bit for bit on the
    CPU (one statistics chunk on both sides, the same reductions)."""
    x, y, grid, _, _ = _sine_basis()
    model = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.5)], grid, n_eigs=10, noise_var=0.1,
                             device="cpu")
    Phi = tphi(model._basis, model.kernels, model.xg, model.x)
    web = gpt.GPweb(Phi, model.y, noise_var=0.1)
    assert web.log_likelihood() == model.log_likelihood()
    rw, rm = web.optimize(**ADAM), model.optimize(**ADAM)
    np.testing.assert_array_equal(rw.losses, rm.losses)
    assert torch.equal(web.log_w, model.log_w) and torch.equal(web.log_noise, model.log_noise)
    xs = torch.linspace(0, 4, 25, dtype=torch.float64)[:, None]
    mean_w, var_w = web.predict(tphi(model._basis, model.kernels, model.xg, xs))
    mean_m, var_m = model.predict(xs)
    assert torch.equal(mean_w, mean_m) and torch.equal(var_w, var_m)


def test_gp_web_chunked_stats_match():
    """Row-chunked reductions over a ragged last chunk (n = 103, chunks of
    25) equal the one-chunk statistics, as in the JAX package."""
    rng = np.random.default_rng(1)
    n, p = 103, 7
    Phi, y = rng.standard_normal((n, p)), rng.standard_normal(n)
    one = gpt.GPweb(Phi, y, noise_var=0.3, stats_chunk=n, device="cpu")
    chunked = gpt.GPweb(Phi, y, noise_var=0.3, stats_chunk=25, device="cpu")
    jax_chunked = gpx.GPweb(Phi, y, noise_var=0.3, stats_chunk=25)
    for a, b in ((chunked.stats.C, one.stats.C), (chunked.stats.v, one.stats.v), (chunked.stats.yy, one.stats.yy)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    np.testing.assert_allclose(chunked.stats.C.numpy(), np.asarray(jax_chunked.stats.C), rtol=1e-12)
    assert chunked.log_likelihood() == pytest.approx(one.log_likelihood(), rel=1e-10)
    assert chunked.log_likelihood() == pytest.approx(jax_chunked.log_likelihood(), rel=1e-12)


def test_gp_web_device_and_no_copy(monkeypatch):
    """A CPU tensor keeps the model on the CPU, and a Φ already of the
    model's dtype and device is reduced in place, not copied; NumPy input
    with no CUDA device and no ``device`` raises; a mismatched y raises."""
    rng = np.random.default_rng(2)
    Phi = torch.as_tensor(rng.standard_normal((40, 5)), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal(40), dtype=torch.float32)
    seen = []
    real = gp_web.basis_stats_from_phi
    monkeypatch.setattr(gp_web, "basis_stats_from_phi", lambda P, yy, chunk: seen.append(P) or real(P, yy, chunk=chunk))
    web = gpt.GPweb(Phi, y, noise_var=0.5)
    assert seen[0].data_ptr() == Phi.data_ptr()
    assert web.log_w.device.type == "cpu" and web.log_w.dtype == torch.float32
    assert web.stats.C.dtype == torch.float32 and not any(t is Phi for t in vars(web).values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.GPweb(Phi.numpy(), y.numpy())
    with pytest.raises(ValueError, match="one response per row of Phi"):
        gpt.GPweb(Phi, y[:-1], device="cpu")
