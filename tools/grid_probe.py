#!/usr/bin/env python3
"""Probe a grid configuration's CG convergence on the card for a list of
lengthscales and noise variances (the choice recorded in PERF.md §4).

Usage, from the repository root, on a machine with a CUDA device:
    python3 tools/grid_probe.py grid32x5_mixed "[(0.15, 1.0), (0.1, 10.0)]"

For each (lengthscale, noise_var) it builds the configuration of
chip_smoke.GRID_CONFIGS with that lengthscale in every dimension (the
8x512x512 lattice keeps its time lengthscale) and prints one JSON line: the
float32 CG NLML, its CG iterations and exact-fallback iterations, its time,
and its gap to the float32 schur NLML.
"""

from __future__ import annotations

import ast
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(name: str, candidates) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("grid_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.GRID_CONFIGS[name]
    xg, y = cs.grid_data(name)
    for ls, noise in candidates:
        lengthscales = tuple(cfg["lengthscales"][:1]) + (ls,) * (len(cfg["sizes"]) - 1) \
            if name == "grid8x512x512_exact" else (ls,) * len(cfg["sizes"])
        cfg.update(lengthscales=lengthscales, noise_var=noise)
        schur = cs.grid_model(name, xg, y, torch.float32, "cuda", solver="schur")
        ll_s, _ = cs.timed(schur.log_likelihood)
        del schur
        model = cs.grid_model(name, xg, y, torch.float32, "cuda")
        ll_c, t = cs.timed(model.log_likelihood)
        info = model.cg_info
        print(json.dumps({"config": name, "lengthscales": list(lengthscales), "noise_var": noise,
                          "nlml_f32_cg": -ll_c, "nlml_f32_schur": -ll_s, "gap": abs(ll_c - ll_s) / abs(ll_s),
                          "cg_iterations": info.iterations, "fallback_iterations": info.fallback_iterations,
                          "s_cg_nlml": t, "card": cs.card_info()}), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1], ast.literal_eval(sys.argv[2]))
