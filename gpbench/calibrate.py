"""The readings that the check's limits are set from, for one cell at its own
size on the card, in one process (the benchmark's runs never run this):

- the program's sound runs, one per seed: set-up (for a training cell the
  checked first steps) and ``--units`` timed units, then the numbers that
  ``gpbench.run`` compares;
- the control on ``--control-seeds``: the plain reference put in the
  program's place and computed one grade below the configuration's float32
  (float32 storage with TF32 matrix products), against the float64
  reference; a control that crashes (a Cholesky that finds its TF32 Gram
  not positive definite) is reported as ``{"crashed": …}``;
- the planted faults on ``--fault-seeds`` (``gpbench.faults``), each run
  through the program.

    python3 -m gpbench.calibrate --workload ski1m_lattice.train --seeds 1,2,3 \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --faults half_probes --units 1

Prints one JSON line per reading: ``{"kind": "sound" | "control" | <fault>,
"seed": …, "numbers": {…}}``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time

import numpy as np


def _ints(s: str) -> list:
    return [int(v) for v in s.split(",") if v]


def one(workload, cfg, traffic, seed, units: int, device: str, control: bool, fault=None):
    """``{kind: numbers}`` of one seed: the program's (sound or with
    ``fault`` planted) and, with ``control``, the control's."""
    import torch

    from gpbench import faults
    from gpbench.drivers import Cell
    from gpbench.reference import Precision

    cell = Cell(workload, cfg, traffic, seed, device)
    driver = importlib.import_module(f"gpbench.drivers.{traffic['driver']}").Driver(cell)
    with faults.planted(fault, cell):
        driver.setup()
        for i in range(units):
            driver.unit(i)
    got = driver.readings()
    driver.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = driver.reference(Precision.exact())
    out = {fault or "sound": driver.compare(got, ref)}
    if "grad" in got:
        leaf = lambda g: {k: [float(v) for v in np.ravel(a)] for k, a in g.items()}  # noqa: E731
        out["leaves"] = {"grad": leaf(got["grad"]), "grad_ref": leaf(ref["grad"]),
                         "losses": list(map(float, got["losses"])), "losses_ref": list(map(float, ref["losses"]))}
    if control:
        try:
            ctl = driver.reference(Precision.control(float(cfg["model"]["cg_tol"])))
            out["control"] = driver.compare(ctl, ref)
        except Exception as e:  # a control that crashes has failed, and gives no reading
            out["control"] = {"crashed": f"{type(e).__name__}: {e}"[:300]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--units", type=int, default=2)
    args = ap.parse_args(argv)
    from gpbench.run import load_cell

    _, _, cfg, traffic, _ = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("gpbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    jobs = [(s, None) for s in seeds] + [(s, f) for f in args.faults.split(",") if f for s in args.fault_seeds]
    for seed, fault in jobs:
        t0 = time.perf_counter()
        res = one(args.workload, cfg, traffic, seed, args.units, "cuda",
                  fault is None and seed in args.control_seeds, fault)
        for kind, numbers in res.items():
            if kind == "sound" and seed not in args.seeds:
                continue
            print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
