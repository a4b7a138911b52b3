#!/usr/bin/env python3
"""The JAX package's numbers for the grid configurations of chip_smoke.py.

Usage, from the repository root (CPU, float64 where stated):
    JAX_PLATFORMS=cpu python tools/grid_reference_jax.py

Prints one JSON line per configuration:

* ``nlml_f64`` — the float64 schur NLML of ``GPKroneckerRegression`` on the
  configuration's float32 data cast to float64 (chip_smoke.JAX_GRID_NLML_F64).
  The 8x512x512 lattice runs the model itself.  The 32^5 lattice
  (M = 33,554,432) streams its first axis: the same closed form from the
  package's own functions (``cov_grid``, ``kron_eigh``, ``_clamp_psd``,
  ``kron_matvec``), ``z = (⊗Q_dᵀ) y`` one row of the first axis at a time,
  so that no M-length float64 vector is held.  A shrunk lattice checks the
  streamed form against ``GPKroneckerRegression(...).log_likelihood()``.
* ``cg_iterations`` — for the 8x512x512 lattice, the float32 CG of the
  model's ``_loss`` (deflated, data-space PCG) rebuilt from the package's
  functions with ``return_info``; its NLML is checked against
  ``log_likelihood()``.  The 32^5 CG is not run here (its state needs more
  memory than a CPU test host gives one process).
"""

from __future__ import annotations

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gp_grief_tpu import GPKroneckerRegression, make_kernel  # noqa: E402
from gp_grief_tpu.kernels.grid import cov_grid  # noqa: E402
from gp_grief_tpu.models.gp_kron import _clamp_psd, _lam_kron  # noqa: E402
from gp_grief_tpu.ops.cg import cg_solve  # noqa: E402
from gp_grief_tpu.ops.kron import kron_eigh, kron_matvec  # noqa: E402
from gp_grief_tpu.ops.kron_fast import kron_matvec_fast  # noqa: E402
from gp_grief_tpu.ops.precond import kron_deflation_sqrt_ops  # noqa: E402
from gp_grief_tpu.ops.topk import top_p_kron_eigs  # noqa: E402


def _model(name, xg, y, dtype, **kw):
    cfg = cs.GRID_CONFIGS[name]
    kerns = [make_kernel("rbf", lengthscale=ls) for ls in cfg["lengthscales"]]
    args = dict(cfg["model"], noise_var=cfg["noise_var"])
    args.update(kw)
    return GPKroneckerRegression([g.astype(dtype) for g in xg], y.astype(dtype), kerns, **args)


def nlml_streamed(name, xg, y) -> float:
    """float64 schur NLML, streaming the first lattice axis."""
    cfg = cs.GRID_CONFIGS[name]
    kerns = [make_kernel("rbf", lengthscale=ls) for ls in cfg["lengthscales"]]
    kerns = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), kerns)
    sigma2 = float(cfg["noise_var"])
    factors = cov_grid(kerns, tuple(jnp.asarray(g, jnp.float64) for g in xg))
    Qs, lams = kron_eigh(factors)
    lams = _clamp_psd(lams)
    lam_rest = _lam_kron(lams[1:])
    QT_rest = tuple(Q.T for Q in Qs[1:])
    Q1, lam1 = np.asarray(Qs[0]), np.asarray(lams[0])
    m1 = Q1.shape[0]
    Y = y.reshape(m1, -1)
    quad = logdet = 0.0
    for i in range(m1):
        u = jnp.zeros(Y.shape[1], jnp.float64)
        for j in range(m1):
            u = u + Q1[j, i] * jnp.asarray(Y[j], jnp.float64)
        z = kron_matvec(QT_rest, u)
        shifted = lam1[i] * lam_rest + sigma2
        quad += float(jnp.sum(z * z / shifted))
        logdet += float(jnp.sum(jnp.log(shifted)))
    M = y.size
    return 0.5 * (quad + logdet + M * math.log(2.0 * math.pi))


def cg_iterations_f32(name, xg, y):
    """float32 CG of the model's _loss with return_info (data-space PCG with
    the rank-p deflation, as cg_whiten='auto' picks at this noise)."""
    cfg = cs.GRID_CONFIGS[name]
    mcfg = cfg["model"]
    model = _model(name, xg, y, np.float32)
    assert not model.cg_whiten and mcfg["cg_precision"] == "exact"
    params = model.params
    sigma2 = jnp.exp(params["log_noise"])
    factors = cov_grid(params["kernels"], model.xg)
    Qs, lams = kron_eigh(factors)
    lams = _clamp_psd(lams)
    _, idx = top_p_kron_eigs(lams, mcfg["precond_rank"])
    M_inv, _, _ = kron_deflation_sqrt_ops(Qs, lams, idx, sigma2)

    def bm(op):
        return lambda v: op(v[0])[None, :]

    alpha, info = cg_solve(bm(lambda u: kron_matvec_fast(factors, u) + sigma2 * u), model.y[None, :],
                           tol=mcfg["cg_tol"], max_iters=mcfg["cg_iters"], M_inv=bm(M_inv), layout="bm",
                           return_info=True)
    quad = float(jnp.dot(model.y, alpha[0]))
    logdet = float(jnp.sum(jnp.log(_lam_kron(lams) + sigma2)))
    nlml = 0.5 * (quad + logdet + model.m * math.log(2.0 * math.pi))
    return int(info.iterations), float(jnp.max(info.residual_norm) / jnp.linalg.norm(model.y)), nlml, \
        -float(model.log_likelihood())


def main() -> None:
    # The streamed form against the model itself on shrunk lattices.
    for name, sizes in (("grid32x5_mixed", (6,) * 5), ("grid8x512x512_exact", (8, 24, 24))):
        xg, y = cs.grid_data(name, sizes)
        want = -float(_model(name, xg, y, np.float64, solver="schur").log_likelihood())
        got = nlml_streamed(name, xg, y)
        print(json.dumps({"check": "streamed vs model", "config": name, "sizes": sizes,
                          "model_nlml": want, "streamed_nlml": got, "rel": abs(got - want) / abs(want)}), flush=True)
    for name in cs.GRID_CONFIGS:
        xg, y = cs.grid_data(name)
        out = {"config": name, "sizes": cs.GRID_CONFIGS[name]["sizes"],
               "lengthscales": cs.GRID_CONFIGS[name]["lengthscales"], "noise_var": cs.GRID_CONFIGS[name]["noise_var"],
               "jax": jax.__version__}
        if name == "grid8x512x512_exact":
            out["nlml_f64"] = -float(_model(name, xg, y, np.float64, solver="schur").log_likelihood())
            out["nlml_f64_streamed"] = nlml_streamed(name, xg, y)
            it, res, nlml_cg, nlml_model = cg_iterations_f32(name, xg, y)
            out.update(cg_iterations=it, cg_rel_residual=res, nlml_f32_cg=nlml_cg, nlml_f32_cg_model=nlml_model)
        else:
            out["nlml_f64"] = nlml_streamed(name, xg, y)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
