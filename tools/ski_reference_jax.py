#!/usr/bin/env python3
"""The JAX package's float64 numbers for the SKI configurations of chip_smoke.py.

Usage, from the repository root (CPU, float64):
    JAX_PLATFORMS=cpu python tools/ski_reference_jax.py [--config NAME] [--m M] [--n N]
        [--cg-tol 1e-10] [--points 256] [--chunk 8] [--out tools/ski_reference_f64.json]

For each configuration of ``chip_smoke.SKI_CONFIGS`` (or the one named), builds
``gp_grief_tpu.GPSKIRegression`` on the configuration's float32 data cast to
float64 and prints one JSON line with ``log_likelihood()`` and
``predict(xs, variance="exact", chunk=...)`` at ``--points`` test points
(``chip_smoke.ski_test_points``).  ``--m``/``--n`` shrink the lattice and the
data (the float64 parity size that chip_smoke.py drives on the card);
``--cg-tol`` replaces the configuration's CG tolerance (1e-6), so that two
float64 runs agree to rounding and not to where each CG stopped; with
``--out`` the lines are also merged into that JSON file, keyed by
configuration.

Four things are set in this process only, so that the port can be held to
these numbers; nothing in the JAX package changes:

* ``jax.random.rademacher`` returns ``chip_smoke.ski_probe(call, shape)``,
  the numpy probes, in call order (call 0: the CG probes, call 1: the SLQ
  probes of one NLML evaluation).
* ``gp_ski.kron_eigh`` flips each eigenvector so that its first entry of
  magnitude ≥ 0.1·max is positive.  The lattice dual draws its probes in the
  Kronecker eigenbasis, so the estimate depends on the eigenvectors' signs,
  which LAPACK and cuSOLVER choose differently.  The port canonicalizes the
  same way.
* ``gp_ski.top_p_kron_eigs`` orders log-eigenvalue sums by their value
  rounded to 1e-7 (ties by index).  With equal kernels on equal grids the
  rank-r deflation cuts through groups of exactly tied products, and which
  member is kept would otherwise follow the last bit of each eigensolver.
  The port selects the same way.
* The interpolation transpose takes the package's exact ELL form
  (``interp_rmatvec_bm_exact``) instead of the one-hot Pallas kernel, which
  runs in interpret mode off a TPU: the same sums, reordered.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import gp_grief_tpu.models.gp_ski as gp_ski  # noqa: E402
from gp_grief_tpu import GPSKIRegression, make_kernel  # noqa: E402

TIE_QUANTUM = 1e-7


class NumpyProbes:
    """Stand-in for ``jax.random.rademacher``: the numpy probes, in call order."""

    def __init__(self):
        self.calls = 0

    def __call__(self, key, shape, dtype=jnp.float64):
        z = cs.ski_probe(self.calls, tuple(int(s) for s in shape))
        self.calls += 1
        return jnp.asarray(z, dtype=dtype)


def canonical_signs(Q):
    """Flip each column so its first entry with |q| ≥ 0.1·max|q| is positive."""
    a = jnp.abs(Q)
    first = jnp.argmax(a >= 0.1 * jnp.max(a, axis=0, keepdims=True), axis=0)
    s = jnp.sign(Q[first, jnp.arange(Q.shape[1])])
    return Q * jnp.where(s == 0, 1.0, s)[None, :]


def kron_eigh_canonical(factors):
    Qs, lams = _KRON_EIGH(factors)
    return tuple(canonical_signs(Q) for Q in Qs), lams


def top_p_kron_eigs_quantized(lams, p, *, min_eig=None):
    """``top_p_kron_eigs`` with sums ordered by their value rounded to
    TIE_QUANTUM, ties by candidate index (the port's ``tie_quantum``)."""
    dtype = jnp.result_type(*lams)
    if min_eig is None:
        min_eig = jnp.finfo(dtype).tiny

    def top(vals, k):
        i = jnp.argsort(-jnp.round(vals / TIE_QUANTUM), stable=True)[:k]
        return vals[i], i

    log0 = jnp.log(jnp.maximum(lams[0].astype(dtype), min_eig))
    k0 = min(p, int(log0.shape[0]))
    vals, i0 = top(log0, k0)
    sums = jnp.concatenate([vals, jnp.full((p - k0,), -jnp.inf, dtype)])
    idx = jnp.zeros((p, len(lams)), jnp.int32).at[:k0, 0].set(i0.astype(jnp.int32))
    for dd in range(1, len(lams)):
        log_d = jnp.log(jnp.maximum(lams[dd].astype(dtype), min_eig))
        m_d = int(log_d.shape[0])
        sums, flat_i = top((sums[:, None] + log_d[None, :]).reshape(-1), p)
        idx = idx[flat_i // m_d].at[:, dd].set((flat_i % m_d).astype(jnp.int32))
    return sums, idx


_KRON_EIGH = gp_ski.kron_eigh


def patch() -> NumpyProbes:
    probes = NumpyProbes()
    jax.random.rademacher = probes
    gp_ski.kron_eigh = kron_eigh_canonical
    gp_ski.top_p_kron_eigs = top_p_kron_eigs_quantized
    return probes


def model(name, x, y, xg, **overrides):
    cfg = cs.SKI_CONFIGS[name]
    kerns = [make_kernel("rbf", lengthscale=cfg["lengthscale"]) for _ in range(cs.SKI_D)]
    m = GPSKIRegression(x, y, kerns, xg, noise_var=cfg["noise_var"], **dict(cfg["model"], **overrides))
    m._oplan = None  # the exact ELL transpose (see the module docstring)
    m._wplan = None
    return m


def run(name, n, m, points, chunk, cg_tol=None):
    probes = patch()
    x, y, xg = cs.ski_data(name, n, m)
    x, y, xg = x.astype(np.float64), y.astype(np.float64), [g.astype(np.float64) for g in xg]
    xs = cs.ski_test_points(name, points).astype(np.float64)
    t0 = time.perf_counter()
    cg_tol = float(cg_tol or cs.SKI_CONFIGS[name]["model"]["cg_tol"])
    jm = model(name, x, y, xg, cg_tol=cg_tol)
    nlml = -float(jm.log_likelihood())
    t_nlml = time.perf_counter() - t0
    assert probes.calls == 2, probes.calls
    t0 = time.perf_counter()
    mean, var = jm.predict(xs, variance="exact", chunk=chunk)
    t_pred = time.perf_counter() - t0
    return {"config": name, "n": int(x.shape[0]), "m": int(xg[0].shape[0]), "cg_tol": cg_tol, "points": points,
            "chunk": chunk,
            "nlml": nlml, "mean": np.asarray(mean).tolist(), "var": np.asarray(var).tolist(),
            "seconds": {"build_and_nlml": t_nlml, "predict": t_pred}, "jax": jax.__version__}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(cs.SKI_CONFIGS), default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--m", type=int, default=None)
    ap.add_argument("--cg-tol", type=float, default=None)
    ap.add_argument("--points", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for name in [args.config] if args.config else list(cs.SKI_CONFIGS):
        out = run(name, args.n, args.m, args.points, args.chunk, args.cg_tol)
        print(json.dumps({k: v for k, v in out.items() if k not in ("mean", "var")}), flush=True)
        if args.out:
            table = json.load(open(args.out)) if os.path.exists(args.out) else {}
            table[name] = out
            with open(args.out, "w") as f:
                json.dump(table, f, indent=1)


if __name__ == "__main__":
    main()
