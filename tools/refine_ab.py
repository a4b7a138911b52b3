#!/usr/bin/env python3
"""The mixed-precision refinement's exact applies, NLMLs and wall times on one
card: grid32x5_mixed's float32 CG NLML (``cg_precision="mixed"``) and
gp40k_matfree's ``mixed16`` segmented NLML, as ``chip_smoke.py`` phases 7
and 13 run them, with every ``cg_solve_refined`` call's exact operator
counted (``chip_smoke.ExactApplies`` of this checkout).

Usage:  python3 tools/refine_ab.py [TREE]

``TREE`` (default: this checkout) is the root of a checkout whose package
and ``chip_smoke.py`` are loaded; run it from two unpacked trees in turns
(parent, change, change, parent) to compare them on one card.  Prints one
JSON line: each NLML (``float.hex``, for a bit-for-bit comparison), its wall
time, and per refined solve its restarts, fallback iterations and exact
applies; the card's name and power limit beside them.
"""

import importlib.util
import json
import os
import sys

tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(__file__), ".."))
here = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, tree)
os.chdir(tree)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gp_grief_tpu_torch.ops.cuda import _build  # noqa: E402

# The counter is this checkout's (the parent's chip_smoke.py may lack it); it
# patches the models of the package loaded above, the tree's.
_spec = importlib.util.spec_from_file_location("chip_smoke_counter", os.path.join(here, "chip_smoke.py"))
_counter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counter)


def main() -> int:
    if not torch.cuda.is_available():
        print("refine_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    out = {"tree": tree}

    xg, y = cs.grid_data("grid32x5_mixed")
    model = cs.grid_model("grid32x5_mixed", xg, y, torch.float32, "cuda")
    for rep in range(2):
        with _counter.ExactApplies() as exact:
            ll, t = cs.timed(model.log_likelihood)
        out.setdefault("grid32x5_mixed", []).append({"nlml_hex": (-ll).hex(), "nlml": -ll, "s": t,
                                                     **exact.solves[-1]})
    del model
    torch.cuda.empty_cache()

    cfg = cs.GP_ITER_CONFIGS["gp40k_matfree"]
    x, y = cs.gp_iter_data(cfg["n"])
    m16 = cs.gp_iter_model(x, y, torch.float32, "cuda", matvec_chunk=cfg["matvec_chunk"], mixed16=True)
    for rep in range(2):
        with _counter.ExactApplies() as exact:
            ll, t = cs.timed(lambda: m16.log_likelihood_iterative_segmented(**cs.GP_ITER_NLML))
        out.setdefault("gp40k_mixed16", []).append({"nlml_hex": (-ll).hex(), "nlml": -ll, "s": t,
                                                     "cg_iterations": m16.cg_iterations, **exact.solves[-1]})
    out["card"] = cs.card_info()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
