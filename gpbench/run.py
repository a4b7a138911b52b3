"""One run of one benchmark cell.

    python3 -m gpbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``gpbench/`` and
the program (``gp_grief_tpu_torch``).  The run:

1. makes the cell's data with NumPy from ``--seed`` and builds the model on
   the card;
2. runs the traffic's set-up units, which warm every shape the window uses;
   ``setup_s`` is the time from the process's start to the window;
3. runs whole units back to back until ``--seconds`` have passed (a closed
   loop); with ``--trace 1`` the window is profiled by ``torch.profiler``
   and lasts ``min(--seconds, TRACE_SECONDS)``, whole units; the same units
   then run again untraced, so that the shares of the window's time are
   taken against the time that work takes without the profiler's host cost;
4. reads the peak device memory, frees the program's state and compares
   what the timed path produced with the plain reference (``reference/``),
   each number against its limit (``limits/<workload>.json``);
5. prints one JSON line last on standard output: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
   ``--trace 1`` the per-layer ones), ``device``, with ``--trace 1`` a
   ``breakdown``, and last ``checks``, each number compared beside its
   limit (also the last lines on standard error).

Without a CUDA card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded in this process once the window has closed, it exits
with a non-zero code and prints no result.  The card's kernels are built by
the program into ``gp_grief_tpu_torch/_build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse
import gc
import importlib
import json
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
# The traced window: long enough for several units of every cell, short
# enough that the profiler's events stay in memory.
TRACE_SECONDS = 8.0
FORBIDDEN = ("jax", "jaxlib", "flax", "gp_grief_tpu")


def load_cell(workload: str):
    """``(spec entry, BENCHMARK.json, config, traffic, limits)`` by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"gpbench: no workload {workload!r} in BENCHMARK.json")
    cfg = json.loads((PKG / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((PKG / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((PKG / "limits" / f"{workload}.json").read_text())
    return entry, bench, cfg, traffic, limits


def forbidden_modules() -> list:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number at or under its limit."""
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values()) and set(numbers) == set(limits)
    return ok, checks


def run_window(driver, seconds: float):
    """Whole units back to back until ``seconds`` have passed:
    ``(units, elapsed, failed)``.  A driver may close its last unit early at
    ``driver.stop_at`` (a fit stops at the Adam step past it)."""
    units, failed = [], 0
    t0 = time.perf_counter()
    driver.stop_at = t0 + seconds
    i = 0
    while True:
        try:
            units.append({**driver.unit(i), "i": i})
        except Exception:  # a unit that raises is a failed unit; the run goes on
            traceback.print_exc()
            failed += 1
        i += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return units, elapsed, failed


def untraced_seconds(driver, units: list) -> float:
    """The seconds the traced window's work takes without the profiler: each
    of its units run again, untraced, to the same number of steps (a fit
    stopped early stops there again)."""
    driver.stop_at = None
    t0 = time.perf_counter()
    for u in units:
        driver.unit(u["i"], steps=u["steps"])
    return time.perf_counter() - t0


def execute(workload: str, bench: dict, cfg: dict, traffic: dict, limits: dict, *, seed: int, seconds: float,
            trace_on: bool, device: str = "cuda", chips: int = 1) -> dict:
    """Set-up, window, peak memory, the check: the run's result line as a
    dict (``device="cpu"`` only for the tests, which skip the look for a
    card).  Raises ``RuntimeError`` if JAX or the JAX package got loaded."""
    import torch

    from gpbench import trace
    from gpbench.drivers import Cell, sync
    from gpbench.reference import Precision

    cuda = device == "cuda"
    rec = trace.Recorder()
    uninstall = trace.install(rec) if trace_on else None
    cell = Cell(workload, cfg, traffic, seed, device)
    driver = importlib.import_module(f"gpbench.drivers.{traffic['driver']}").Driver(cell)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    sync(device)
    setup_s = time.perf_counter() - T_START
    print(f"gpbench: {workload} set-up {setup_s:.3f} s", file=sys.stderr, flush=True)

    if trace_on:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            rec.on = True
            with torch.profiler.record_function("gpbench.window"):
                units, elapsed, failed = run_window(driver, min(seconds, TRACE_SECONDS))
            rec.on = False
        profile = trace.reduce_profile(prof)
        del prof
        untraced_s = untraced_seconds(driver, units)
    else:
        units, elapsed, failed = run_window(driver, seconds)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    print(f"gpbench: {len(units)} units in {elapsed:.3f} s, {failed} failed", file=sys.stderr, flush=True)

    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    out = {}
    if trace_on:
        ctx = {"profile": profile, "calls": rec.calls, "shapes": rec.shapes, "apply_span": cell.family.APPLY_SPAN,
               "units": units, "untraced_s": untraced_s}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            val = importlib.import_module(f"gpbench.metrics.{m['name'].split('.')[0]}").read(ctx)
            if val is not None:
                out[m["name"]] = {"value": float(val), "unit": m["unit"]}
        dev.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        print(f"gpbench: trace {profile['kernels']} device operations, {profile['in_spans']} inside operator spans; "
              f"span device seconds {profile['span_device_s']}; the traced units take {untraced_s:.3f} s untraced",
              file=sys.stderr, flush=True)
    else:
        e2e = driver.end_to_end(units, elapsed)
        e2e["setup_s"] = setup_s
        units_of = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        out = {k: {"value": float(v), "unit": units_of[k]} for k, v in e2e.items()}

    got = driver.readings()
    driver.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.compare(got, driver.reference(Precision.exact()))
    correct, checks = judge(numbers, limits)
    result = {"correct": bool(correct and failed == 0), "attempted": len(units) + failed, "failed": failed,
              "metrics": out, "device": dev}
    if trace_on:
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    result["checks"] = checks
    if uninstall is not None:
        uninstall()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    entry, bench, cfg, traffic, limits = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"gpbench: the cell needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = execute(args.workload, bench, cfg, traffic, limits, seed=args.seed, seconds=args.seconds,
                         trace_on=bool(args.trace), chips=int(entry["chips"]))
    except RuntimeError as e:
        print(f"gpbench: {e}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
