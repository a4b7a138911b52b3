"""``GPSKIRegression``'s serving path against the JAX package's, float64 on
the CPU, on the same NumPy inputs (n ≤ 400 points in 3-D, a 6×7×5 grid).

Both packages are handed the same NumPy Rademacher probes and the same
eigen-conventions through ``tools/ski_reference_jax.py``'s patches (the JAX
side: ``jax.random.rademacher``, sign-canonical eigenvectors, tie-ordered
deflation; the port does the latter two itself), and the port's one draw
function ``ops.lanczos.rademacher`` is replaced by the same probes.
Tolerance 1e-8 relative: the NLML's CG stops at cg_tol = 1e-10 and its SLQ
runs a fixed number of steps, so the two differ by rounding only; predict's
means and variances pass through CG solves at the same tolerance.
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gp_grief_tpu as gpx
import gp_grief_tpu.models.gp_ski as jski
import gp_grief_tpu_torch as gpt
import gp_grief_tpu_torch.ops.lanczos as tlz
import jax
from gp_grief_tpu_torch.convert import params_from_jax
from tools import ski_reference_jax as ref

torch.set_num_threads(1)

TOL = 1e-8
LENGTHSCALES = (0.8, 0.9, 1.1)  # unequal: no exactly tied eigenvalue products


@pytest.fixture
def probes(monkeypatch):
    jp, tp = ref.NumpyProbes(), cs.NumpyProbes()
    monkeypatch.setattr(jax.random, "rademacher", jp)
    monkeypatch.setattr(jski, "kron_eigh", ref.kron_eigh_canonical)
    monkeypatch.setattr(jski, "top_p_kron_eigs", ref.top_p_kron_eigs_quantized)
    monkeypatch.setattr(tlz, "rademacher", tp)
    return jp, tp


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 3, (n, 3))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.3 * x[:, 2] + 0.05 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 3.1, m)[:, None] for m in (6, 7, 5)]
    xs = rng.uniform(0.2, 2.8, (20, 3))
    return x, y, xg, xs


def _pair(**kw):
    x, y, xg, _ = _data()
    args = dict(dict(noise_var=0.2, num_probes=4, lanczos_iters=12, cg_iters=200, cg_tol=1e-10), **kw)
    jm = gpx.GPSKIRegression(x, y, [gpx.make_kernel("rbf", lengthscale=ls) for ls in LENGTHSCALES], xg, **args)
    tm = gpt.GPSKIRegression(x, y, [gpt.make_kernel("rbf", lengthscale=ls) for ls in LENGTHSCALES], xg,
                             device="cpu", **args)
    return jm, tm


def _nlml_pair(probes, **kw):
    jm, tm = _pair(**kw)
    probes[0].calls = probes[1].calls = 0
    lj = jm.log_likelihood()
    lt = tm.log_likelihood()
    assert probes[0].calls == probes[1].calls == 2  # CG probes, then SLQ probes
    return jm, tm, lj, lt


@pytest.mark.parametrize("rank,precision", [(0, "exact"), (12, "exact"), (0, "mixed"), (12, "mixed")])
def test_log_likelihood_data_solver_matches_jax(probes, rank, precision):
    _, tm, lj, lt = _nlml_pair(probes, solver="data", precond_rank=rank, cg_precision=precision)
    assert lt == pytest.approx(lj, rel=TOL)
    assert tm.cg_info.iterations > 0


@pytest.mark.parametrize("stencil", [True, False])
def test_log_likelihood_lattice_solver_matches_jax(probes, stencil):
    _, tm, lj, lt = _nlml_pair(probes, solver="lattice", wtw_stencil=stencil)
    assert lt == pytest.approx(lj, rel=TOL)
    assert (tm._wtw_stencil is not None) == stencil


@pytest.mark.parametrize("solver", ["data", "lattice"])
@pytest.mark.parametrize("variance", ["exact", "lanczos"])
def test_predict_matches_jax(probes, solver, variance):
    jm, tm = _pair(solver=solver, precond_rank=12)
    xs = _data()[3]
    kw = dict(variance=variance, var_rank=30, love_on_fail="warn", chunk=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the LOVE guard at rank 30
        mj, vj = jm.predict(xs, **kw)
        mt, vt = tm.predict(xs, **kw)
    assert mt.shape == vt.shape == (20,) and mt.dtype == torch.float64
    np.testing.assert_allclose(mt.numpy(), mj, rtol=TOL, atol=TOL * np.abs(mj).max())
    np.testing.assert_allclose(vt.numpy(), vj, rtol=TOL, atol=TOL * np.abs(vj).max())
    mean_only = tm.predict(xs, compute_var=False)
    np.testing.assert_allclose(mean_only.numpy(), mt.numpy(), rtol=TOL, atol=TOL * np.abs(mj).max())


def test_love_guard_policies_match_jax(probes):
    """At a rank far too low for the lattice the guard trips in both
    packages: "raise" raises, "exact" returns the exact route's answer, and
    love_check=0 stays silent."""
    jm, tm = _pair(solver="lattice")
    xs = _data()[3]
    kw = dict(variance="lanczos", var_rank=3, love_tol=0.02)
    with pytest.raises(RuntimeError, match="deviates"):
        jm.predict(xs, love_on_fail="raise", **kw)
    with pytest.raises(RuntimeError, match="deviates"):
        tm.predict(xs, love_on_fail="raise", **kw)
    with pytest.warns(UserWarning, match="auto-upgrading"):
        mu, vu = tm.predict(xs, **kw)
    me, ve = tm.predict(xs, variance="exact")
    np.testing.assert_allclose(vu.numpy(), ve.numpy(), rtol=1e-12)
    np.testing.assert_allclose(mu.numpy(), me.numpy(), rtol=1e-12)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        tm.predict(xs, variance="lanczos", var_rank=3, love_check=0)
    with pytest.raises(ValueError, match="love_on_fail"):
        tm.predict(xs, variance="lanczos", love_on_fail="upgrade")


def test_kernel_matvec_and_empty_predict_match_jax():
    jm, tm = _pair(solver="data")
    v = np.random.default_rng(1).standard_normal((400, 2))
    np.testing.assert_allclose(tm.kernel_matvec(torch.as_tensor(v)).numpy(), np.asarray(jm.kernel_matvec(v)),
                               rtol=1e-12, atol=1e-12)
    mean, var = tm.predict(np.zeros((0, 3)))
    assert mean.shape == var.shape == (0,)


def test_params_from_jax_on_a_ski_model():
    jm, tm = _pair(noise_var=0.37)
    flat = dict(zip(jm._param_leaf_names(), jax.tree_util.tree_leaves(jm.params)))
    state = params_from_jax(flat)
    assert sorted(state) == sorted(dict(tm.named_parameters()))
    tm.load_state_dict(state)
    np.testing.assert_allclose(tm.parameters, np.asarray(jm.parameters), rtol=0, atol=0)


def test_training_entry_points_raise():
    """The training entry points, which raised before the training slice,
    run for both solvers: two steps of ``optimize`` (through ``fit``) and of
    ``optimize_segmented``, and the segmented NLML, all finite."""
    for solver in ("data", "lattice"):
        _, tm = _pair(solver=solver, precond_rank=12, cg_tol=1e-8)
        fit = tm.optimize(optimizer="adam", max_iters=2, learning_rate=0.05)
        seg = tm.optimize_segmented(max_iters=2, num_probes=2, cg_segment_iters=20)
        ll = tm.log_likelihood_segmented(probe_chunk=2)
        assert fit.iterations == seg.iterations == 2 and tm.cg_iterations > 0
        assert np.all(np.isfinite(fit.losses)) and np.all(np.isfinite(seg.losses)) and np.isfinite(ll)
