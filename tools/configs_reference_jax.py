#!/usr/bin/env python3
"""The JAX package's float64 numbers for sine1d, grid3d and d100 (chip_smoke.JAX_CONFIGS).

Usage, from the repository root (CPU, float64):
    JAX_PLATFORMS=cpu python tools/configs_reference_jax.py [names]

Runs ``benchmarks/run_configs.py``'s own config functions, unchanged, and
prints one JSON line per configuration with every value its line carries,
unrounded (that runner rounds to 6 decimals), and for sine1d also the
trained NLML of its GP-GRIEF and exact-GP models (``nlml_grief``,
``nlml_exact``): the package's model classes are wrapped to record the
instances the function builds.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import gp_grief_tpu as gpx  # noqa: E402
from benchmarks import run_configs as rc  # noqa: E402


def run(name: str) -> dict:
    out, built = {}, {"GPGriefModel": [], "GPRegression": []}
    originals = {cls: getattr(gpx, cls) for cls in built}

    def recorder(cls):
        def make(*args, **kwargs):
            model = originals[cls](*args, **kwargs)
            built[cls].append(model)
            return model

        return make

    rc._emit = lambda _, **kv: out.update(kv)
    for cls in built:
        setattr(gpx, cls, recorder(cls))
    try:
        rc.ALL[name]()
    finally:
        for cls, orig in originals.items():
            setattr(gpx, cls, orig)
    if name == "sine1d":  # the first model of each class is the trained one
        out["nlml_grief"] = -built["GPGriefModel"][0].log_likelihood()
        out["nlml_exact"] = -built["GPRegression"][0].log_likelihood()
    return out


if __name__ == "__main__":
    for name in sys.argv[1:] or ["sine1d", "grid3d", "d100"]:
        print(json.dumps({"config": name, **run(name)}), flush=True)
