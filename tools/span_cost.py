#!/usr/bin/env python3
"""What the program's own spans and counters (``utils.profiling``) cost on
the host, and where they land in a profiler's trace.

1. Off: ``span`` and ``site`` with four attributes and with none,
   ``host_read``, ``count`` and a ``spanned`` function, each with no
   profiler recording: µs per call, less the same loop around an empty
   call, from ``--repeats`` rounds of ``--calls`` calls that take the cases
   in turn; the least round (the cost, noise only adds to it) and the
   median.
2. On: the same under a CPU profiler.
3. A small SKI model's ``log_likelihood_segmented`` and ``predict`` on
   ``--device`` under a profiler (with the card's activity on CUDA): the
   ``gp_grief.*`` events by device type and scope (none may lie on the
   device, none at ``USER_SCOPE``), and the device-side user ranges the
   trace holds.

One JSON line.  Run from the repository root:
``python3 tools/span_cost.py [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gp_grief_tpu_torch.utils import profiling  # noqa: E402


@profiling.spanned("gp_grief.tool.fn")
def _decorated():
    return None


def _empty():
    return None


_site = profiling.site("gp_grief.tool.site", "route", "B", "M", "grade")
_bare_site = profiling.site("gp_grief.tool.bare_site")


def _cases():
    def span4():
        with profiling.span("gp_grief.tool.kron", route="slab", B=9, M=1048576, grade="highest"):
            pass

    def site4():
        with _site("slab", 9, 1048576, "highest"):
            pass

    def span0():
        with profiling.span("gp_grief.tool.bare"):
            pass

    def site0():
        with _bare_site():
            pass

    def read():
        with profiling.host_read("tool"):
            pass

    def count():
        profiling.count("tool", 5)

    return {"span_4_attrs": span4, "site_4_attrs": site4, "span_no_attrs": span0,
            "site_no_attrs": site0, "host_read": read, "count": count,
            "spanned_fn": _decorated}


def _per_call_us(cases: dict, calls: int, repeats: int) -> dict:
    """``{case: {"min": µs, "median": µs}}``, the cases taken in turn."""

    def loop(f):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            f()
        return time.perf_counter_ns() - t0

    rounds = {k: [] for k in cases}
    for _ in range(repeats):
        for k, fn in cases.items():
            rounds[k].append((loop(fn) - loop(_empty)) / calls * 1e-3)
    return {k: {"min": min(v), "median": statistics.median(v)} for k, v in rounds.items()}


def _ski(device: str):
    import gp_grief_tpu_torch as gpt

    rng = np.random.default_rng(0)
    n, d = 50000, 4
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    grid = [np.linspace(-0.05, 1.05, 16, dtype=np.float32)[:, None] for _ in range(d)]
    return gpt.GPSKIRegression(x, y, [gpt.make_kernel("rbf", lengthscale=0.3) for _ in range(d)], grid,
                               noise_var=0.05, solver="lattice", num_probes=8, lanczos_iters=30, cg_tol=1e-6,
                               cg_iters=300, seed=1, dtype=torch.float32, device=device), \
        rng.uniform(0.05, 0.95, (16, d)).astype(np.float32)


def _trace_check(device: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    model, xs = _ski(device)
    model.log_likelihood_segmented()
    model.predict(xs)
    if device == "cuda":
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    profiling.reset()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("tool.window"):
            model.log_likelihood_segmented()
            model.predict(xs)
            if device == "cuda":
                torch.cuda.synchronize()
    kinds, device_ranges, device_events = Counter(), Counter(), 0
    for e in prof.profiler.kineto_results.events():
        on_device = "CUDA" in str(e.device_type())
        device_events += on_device
        if e.name().startswith("gp_grief."):
            kinds[f"{'device' if on_device else 'host'}/scope{int(e.scope())}"] += 1
        elif on_device and e.is_user_annotation():
            device_ranges[e.name()] += 1
    snap = profiling.snapshot()
    return {"gp_grief_events": dict(kinds), "device_user_ranges": dict(device_ranges), "device_events": device_events,
            "spans": {k: v["calls"] for k, v in snap["spans"].items()}, "counters": snap["counters"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("--calls", type=int, default=200000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    cases = _cases()
    off = _per_call_us(cases, args.calls, args.repeats)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _per_call_us(cases, args.calls // 10, args.repeats)
    profiling.reset()
    out = {"off_us": off, "on_us": on, "trace": _trace_check(args.device), "device": args.device,
           "card": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu", "torch": torch.__version__}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
