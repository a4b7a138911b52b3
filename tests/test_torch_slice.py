"""The slice as a whole: a kin40k-shaped run through both packages' public
APIs (benchmarks/run_configs.py:kin40k cut to n = 2000, mbar = 8, p = 100,
10 + 10 Adam steps), float64 on the CPU.

Tolerance 1e-6 relative on the final NLML and the predictions: both runs
take the same 20 Adam steps through eigh, top-p selection and Cholesky, whose
float64 rounding differs between the two frameworks by ~1e-15 per step.
"""

import numpy as np
import pytest
import torch

import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt

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
