#!/usr/bin/env python3
"""float32-against-float64 gaps of a SKI configuration, in the JAX package and in the port.

Usage, from the repository root (CPU):
    JAX_PLATFORMS=cpu python tools/ski_f32_gap_jax.py --config ski1m_lattice --m 12 --n 20000

Builds the configuration of ``chip_smoke.SKI_CONFIGS`` at a reduced lattice
(``--m`` points a dimension, ``--n`` points) in float64 and in float32, in the
JAX package (with tools/ski_reference_jax.py's numpy probes and
eigen-conventions) and in the port (``device="cpu"``, the same probes), and
prints one JSON line: the NLML's relative gap, and the largest gap of the
predictive mean (2,000 points) and exact variance (128 points) relative to the
float64 values' largest magnitude, for each package.  chip_smoke.py holds the
card's float32 predictions to its float64 ones; this tool says whether a gap
it measures is the port's or the float32 model's, which both packages share.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ski_reference_jax as ref  # noqa: E402  (sets jax to the CPU and x64)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def gaps(a, b) -> dict:
    """Relative gaps of (nlml, mean, var) ``a`` from the float64 ``b``."""
    return {"nlml": abs(a[0] - b[0]) / abs(b[0]),
            "mean": float(np.abs(a[1] - b[1]).max() / np.abs(b[1]).max()),
            "var": float(np.abs(a[2] - b[2]).max() / np.abs(b[2]).max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(cs.SKI_CONFIGS), required=True)
    ap.add_argument("--m", type=int, required=True)
    ap.add_argument("--n", type=int, required=True)
    args = ap.parse_args()
    cs.DEVICE = "cpu"
    name = args.config
    x, y, xg = cs.ski_data(name, args.n, args.m)
    xm, xv = cs.ski_test_points(name, 2000), cs.ski_test_points(name, 128, seed=2)
    out = {}
    for tag, dt, tdt in (("f64", np.float64, torch.float64), ("f32", np.float32, torch.float32)):
        xd, yd, gd = x.astype(dt), y.astype(dt), [g.astype(dt) for g in xg]
        ref.patch()
        jm = ref.model(name, xd, yd, gd)
        nl = -float(jm.log_likelihood())
        mean = jm.predict(xm.astype(dt), compute_var=False)
        mean = mean[0] if isinstance(mean, tuple) else mean
        _, var = jm.predict(xv.astype(dt), variance="exact")
        out["jax", tag] = (nl, np.asarray(mean, np.float64).ravel(), np.asarray(var, np.float64))
        tm = cs.ski_model(name, xd, yd, gd, tdt)
        nl = cs.with_numpy_probes(lambda: -tm.log_likelihood())
        mean = tm.predict(xm.astype(dt), compute_var=False)
        _, var = tm.predict(xv.astype(dt))
        out["port", tag] = (nl, mean.double().numpy().ravel(), var.double().numpy())
    print(json.dumps({"config": name, "m": args.m, "n": args.n,
                      "jax_f32_vs_f64": gaps(out["jax", "f32"], out["jax", "f64"]),
                      "port_f32_vs_f64": gaps(out["port", "f32"], out["port", "f64"]),
                      "port_f64_vs_jax_f64": gaps(out["port", "f64"], out["jax", "f64"])}))


if __name__ == "__main__":
    main()
