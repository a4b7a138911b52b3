#!/usr/bin/env python3
"""The JAX package's float64 NLML gradients for the SKI configurations of chip_smoke.py.

Usage, from the repository root (CPU, float64):
    JAX_PLATFORMS=cpu python tools/ski_train_reference_jax.py [--config NAME]
        [--out tools/ski_train_reference_f64.json]

For each configuration of ``chip_smoke.SKI_CONFIGS`` (or the one named), builds
``gp_grief_tpu.GPSKIRegression`` at the size and CG tolerance that
``tools/ski_reference_f64.json`` records for it (read, never written), on the
configuration's float32 data cast to float64, and prints one JSON line with
``jax.value_and_grad(model._loss)(model.params)``: the NLML and its BBMM
surrogate gradient (``_loss`` for the data solver, ``_loss_lattice`` for the
lattice dual), the gradient in the order of ``model._param_leaf_names()``.
With ``--out`` the lines are also merged into that JSON file, keyed by
configuration.  ``chip_smoke.py``'s ``ski_train`` phase holds the port's
float64 gradient on the card to these numbers.

The same four things as ``tools/ski_reference_jax.py`` are set in this process
only (that module's ``patch`` and ``model``): the NumPy probes of
``chip_smoke.ski_probe`` in call order (call 0: the CG probes, call 1: the SLQ
probes), sign-canonical eigenvectors, tie-ordered deflation and the exact ELL
interpolation transpose.  Nothing in the JAX package changes.
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
from tools import ski_reference_jax as ref  # noqa: E402

REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ski_reference_f64.json")


def run(name: str) -> dict:
    size = json.load(open(REFERENCE))[name]
    probes = ref.patch()
    x, y, xg = cs.ski_data(name, size["n"], size["m"])
    x, y, xg = x.astype(np.float64), y.astype(np.float64), [g.astype(np.float64) for g in xg]
    jm = ref.model(name, x, y, xg, cg_tol=size["cg_tol"])
    t0 = time.perf_counter()
    nlml, grad = jax.value_and_grad(jm._loss)(jm.params)
    grad = [float(v) for v in np.concatenate([np.ravel(g) for g in jax.tree_util.tree_leaves(grad)])]
    seconds = time.perf_counter() - t0
    assert probes.calls == 2, probes.calls
    return {"config": name, "n": size["n"], "m": size["m"], "cg_tol": size["cg_tol"],
            "solver": cs.SKI_CONFIGS[name]["model"]["solver"], "nlml": float(nlml),
            "leaves": list(jm._param_leaf_names()), "grad": grad, "seconds": seconds, "jax": jax.__version__}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(cs.SKI_CONFIGS), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for name in [args.config] if args.config else list(cs.SKI_CONFIGS):
        out = run(name)
        print(json.dumps(out), flush=True)
        if args.out:
            table = json.load(open(args.out)) if os.path.exists(args.out) else {}
            table[name] = out
            with open(args.out, "w") as f:
                json.dump(table, f, indent=1)


if __name__ == "__main__":
    main()
