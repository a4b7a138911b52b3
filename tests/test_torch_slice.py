"""The slices as a whole, float64 on the CPU, through both packages' public
APIs.

* GP-GRIEF: a kin40k-shaped run (benchmarks/run_configs.py:kin40k cut to
  n = 2000, mbar = 8, p = 100, 10 + 10 Adam steps).  Tolerance 1e-6 relative
  on the final NLML and the predictions: both runs take the same 20 Adam
  steps through eigh, top-p selection and Cholesky, whose float64 rounding
  differs between the two frameworks by ~1e-15 per step.
* The grid GP: chip_smoke.py's two grid configurations with their lattices
  shrunk to a few thousand points and everything else kept (the mixed
  refinement of grid32x5_mixed; the deflated exact CG of
  grid8x512x512_exact, its rank cut with the lattice).
* SKI: chip_smoke.py's two SKI configurations with n cut to 600 points and
  the 32^4 lattice to 6^4 (ski100k_data) or 5^4 (ski1m_lattice), everything
  else kept: solver, kernel, noise, probes, Lanczos steps, CG tolerance, and
  the deflation rank 256 (capped by n and M as in both packages), which at
  equal kernels on equal grids cuts through tied eigenvalue products.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import gp_grief_tpu as gpx
import gp_grief_tpu.models.gp_ski as jski
import gp_grief_tpu_torch as gpt
import gp_grief_tpu_torch.ops.lanczos as tlz
import jax
from tools import ski_reference_jax as ski_ref

torch.set_num_threads(1)


def _kin40k_like(n=2500, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, d))
    f = (np.sin(3 * x[:, 0] * x[:, 1]) + x[:, 2] * np.cos(2 * x[:, 3])
         + np.sin(x[:, 4] + 2 * x[:, 5]) * x[:, 6] + 0.5 * x[:, 7] ** 2)
    y = f + 0.05 * rng.standard_normal(n)
    return x[:2000], y[:2000], x[2000:]


def _run(pkg, xtr, ytr, xte, **kw):
    grid = pkg.InducingGrid.build(xtr, mbar=8)
    kerns = [pkg.make_kernel("rbf", lengthscale=0.7) for _ in range(xtr.shape[1])]
    model = pkg.GPGriefModel(xtr, ytr, kerns, grid, n_eigs=100, noise_var=0.1,
                             opt_kernel_params=True, dim_noise_var=1e-6, **kw)
    model.optimize(optimizer="adam", max_iters=10, learning_rate=0.03)
    model.opt_kernel_params = False
    model.refresh_basis()
    model.optimize(optimizer="adam", max_iters=10, learning_rate=0.05)
    mean, var = model.predict(xte, include_noise=True)
    return model, np.asarray(mean), np.asarray(var)


def test_kin40k_shaped_slice_matches_jax():
    xtr, ytr, xte = _kin40k_like()
    jm, mj, vj = _run(gpx, xtr, ytr, xte)
    tm, mt, vt = _run(gpt, xtr, ytr, xte, dtype=torch.float64, device="cpu")
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-6)
    np.testing.assert_allclose(tm.parameters, jm.parameters, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(mt, mj, rtol=1e-6, atol=1e-6 * np.abs(mj).max())
    np.testing.assert_allclose(vt, vj, rtol=1e-6)
    assert mt.shape == (500,) and np.all(vt > 0)


@pytest.mark.parametrize("name,sizes,rank", [
    ("grid32x5_mixed", (6, 6, 6, 6, 6), 0),
    ("grid8x512x512_exact", (8, 16, 16), 32),
])
def test_grid_configurations_shrunk_match_jax(name, sizes, rank):
    """NLML of the configuration's CG path and of schur agree to 1e-9 (CG to
    relative residual 1e-6: the quadratic term's error is ~tol²·κ); predict
    means and variances to 1e-10."""
    cfg = chip_smoke.GRID_CONFIGS[name]
    xg, y = chip_smoke.grid_data(name, sizes)
    xg, y = [g.astype(np.float64) for g in xg], y.astype(np.float64)
    xs = chip_smoke.grid_test_points(xg, 40)
    kw = dict(cfg["model"], noise_var=cfg["noise_var"], precond_rank=rank)

    def pair(**over):
        args = dict(kw, **over)
        jm = gpx.GPKroneckerRegression(xg, y, [gpx.make_kernel("rbf", lengthscale=ls) for ls in cfg["lengthscales"]],
                                       **args)
        tm = gpt.GPKroneckerRegression(xg, y, [gpt.make_kernel("rbf", lengthscale=ls) for ls in cfg["lengthscales"]],
                                       device="cpu", **args)
        return jm, tm

    jm, tm = pair()
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-9)
    assert tm.cg_info.fallback_iterations == 0
    js, ts = pair(solver="schur")
    assert ts.log_likelihood() == pytest.approx(js.log_likelihood(), rel=1e-12)
    assert ts.log_likelihood() == pytest.approx(tm.log_likelihood(), rel=1e-9)
    mj, vj = jm.predict(xs)
    mt, vt = tm.predict(xs)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,n,m", [("ski100k_data", 600, 6), ("ski1m_lattice", 600, 5)])
def test_ski_configurations_shrunk_match_jax(monkeypatch, name, n, m):
    """Both packages on the same NumPy probes (tools/ski_reference_jax.py's
    patches; chip_smoke.NumpyProbes for the port): float64 NLML and exact
    predictions (16 points) to 1e-8 relative, as chip_smoke holds the card
    to the JAX package: with cg_tol tightened to 1e-10 (at 1e-6 the two
    packages' CG stop a step apart and the means differ by ~1.5e-8)."""
    cfg = chip_smoke.SKI_CONFIGS[name]
    jp, tp = ski_ref.NumpyProbes(), chip_smoke.NumpyProbes()
    monkeypatch.setattr(jax.random, "rademacher", jp)
    monkeypatch.setattr(jski, "kron_eigh", ski_ref.kron_eigh_canonical)
    monkeypatch.setattr(jski, "top_p_kron_eigs", ski_ref.top_p_kron_eigs_quantized)
    monkeypatch.setattr(tlz, "rademacher", tp)
    x, y, xg = chip_smoke.ski_data(name, n, m)
    x, y, xg = x.astype(np.float64), y.astype(np.float64), [g.astype(np.float64) for g in xg]
    xs = chip_smoke.ski_test_points(name, 16).astype(np.float64)
    jm = ski_ref.model(name, x, y, xg, cg_tol=1e-10)
    tm = gpt.GPSKIRegression(x, y, [gpt.make_kernel("rbf", lengthscale=cfg["lengthscale"]) for _ in range(4)], xg,
                             noise_var=cfg["noise_var"], device="cpu", **dict(cfg["model"], cg_tol=1e-10))
    lj, lt = jm.log_likelihood(), tm.log_likelihood()
    assert jp.calls == tp.calls == 2
    assert lt == pytest.approx(lj, rel=chip_smoke.SKI_F64_RTOL)
    mj, vj = jm.predict(xs, variance="exact", chunk=8)
    mt, vt = tm.predict(xs, variance="exact", chunk=8)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=0, atol=chip_smoke.SKI_F64_RTOL * np.abs(mj).max())
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=chip_smoke.SKI_F64_RTOL * np.abs(vj).max())


def test_slice_modules_import_without_jax():
    """This slice's modules, imported alone in a fresh interpreter, load
    neither jax nor the JAX package."""
    mods = ["gp_grief_tpu_torch.models.gp_ski", "gp_grief_tpu_torch.ops.interp", "gp_grief_tpu_torch.ops.interp_stencil",
            "gp_grief_tpu_torch.ops.lanczos", "gp_grief_tpu_torch.ops.cuda.interp",
            "gp_grief_tpu_torch.ops.cuda.stencil", "gp_grief_tpu_torch.ops.precond"]
    code = ("import sys, importlib; sys.path.insert(0, sys.argv[1]); [importlib.import_module(m) for m in sys.argv[2:]]; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'gp_grief_tpu' "
            "or m.startswith('gp_grief_tpu.')]; assert not bad, bad")
    repo = str(Path(__file__).resolve().parents[1])
    proc = subprocess.run([sys.executable, "-c", code, repo, *mods], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
