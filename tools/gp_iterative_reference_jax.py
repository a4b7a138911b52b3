#!/usr/bin/env python3
"""The JAX package's float64 run of GPRegression's iterative recipe for chip_smoke.py.

Usage, from the repository root (CPU, float64):
    JAX_PLATFORMS=cpu python tools/gp_iterative_reference_jax.py [--out tools/gp_iterative_reference_f64.json]

Builds ``gp_grief_tpu.GPRegression(solver="iterative")`` on
``chip_smoke.gp_iter_data``'s recipe (benchmarks/exp_r15_train500k.py: RBF
lengthscale 0.8, noise 0.3, rank-128 whitening, 8 probes, 24 Lanczos steps)
at ``REFERENCE``'s size, matrix-free, float32 data cast to float64, with CG
to 1e-12, and records, in this order:

1. ``log_likelihood_iterative_segmented(**chip_smoke.GP_ITER_NLML)`` (one
   probe chunk);
2. ``jax.value_and_grad(model._loss)(model.params)``, the gradient in the
   order of ``model._param_leaf_names()``;
3. the parameters after one ``optimize_segmented(**chip_smoke.GP_ITER_TRAIN)``
   step;
4. ``predict`` (means and exact variances) at ``chip_smoke.gp_iter_test_points``.

The probes are ``chip_smoke.ski_probe``'s NumPy draws in call order
(``tools/ski_reference_jax.NumpyProbes`` in place of
``jax.random.rademacher``, in this process only): call 0 the segmented
NLML's chunk, 1-2 the loss's ``z`` and SLQ probes, 3 the training step's.
``chip_smoke.py``'s phase 13 replays the sequence on the card in float64
with the same probes and holds it to these numbers.  Prints the JSON;
``--out`` writes it.  About a minute here.
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

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import gp_grief_tpu as gpx  # noqa: E402
from tools import ski_reference_jax as ref  # noqa: E402

REFERENCE = dict(n=4096, matvec_chunk=1024, cg_tol=1e-12, cg_iters=1000, test_points=64)


def run() -> dict:
    probes = ref.NumpyProbes()
    jax.random.rademacher = probes
    x, y = cs.gp_iter_data(REFERENCE["n"])
    xs = cs.gp_iter_test_points(REFERENCE["test_points"]).astype(np.float64)
    opts = {**cs.GP_ITER, **{k: REFERENCE[k] for k in ("matvec_chunk", "cg_tol", "cg_iters")}}
    jm = gpx.GPRegression(x.astype(np.float64), y.astype(np.float64),
                          gpx.make_kernel("rbf", lengthscale=0.8, input_dim=2), noise_var=0.3, solver="iterative",
                          **opts)
    t0 = time.perf_counter()
    nlml_seg = -jm.log_likelihood_iterative_segmented(**cs.GP_ITER_NLML)
    loss, grad = jax.value_and_grad(jm._loss)(jm.params)
    grad = np.concatenate([np.ravel(g) for g in jax.tree_util.tree_leaves(grad)])
    jm.optimize_segmented(max_iters=1, **cs.GP_ITER_TRAIN)
    mean, var = jm.predict(xs)
    seconds = time.perf_counter() - t0
    assert probes.calls == 4, probes.calls
    return {**REFERENCE, **{k: v for k, v in opts.items() if k not in REFERENCE}, "leaves": list(jm._param_leaf_names()),
            "nlml_segmented": float(nlml_seg), "loss": float(loss), "grad": [float(v) for v in grad],
            "params_after_step": [float(v) for v in jm.parameters], "mean": [float(v) for v in mean],
            "var": [float(v) for v in var], "seconds": seconds, "jax": jax.__version__}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = run()
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
