#!/usr/bin/env python3
"""Device-time breakdown of kernels K2/K3 and of the grid configurations'
CG log-likelihood on the card (PERF.md §5).

Usage, from the repository root, on a machine with a CUDA device:
    python3 tools/kron_profile.py

Prints JSON lines: for K2 at 32^5 ("default", bf16 storage between passes)
and K3 at 8x512x512 ("highest"), the device time of each kernel launched
over 10 calls; for each grid configuration of chip_smoke.GRID_CONFIGS, one
CG log-likelihood's wall time, device time, idle share and its ten largest
device items.  Times come from torch.profiler's CUDA activity.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _device_items(prof, top=10):
    """Device kernels only (the CPU-side ops that launched them also report
    the same device time, and would count it twice)."""
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((ev.key, dev / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return total, [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:top]]


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("kron_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from gp_grief_tpu_torch.ops.cuda import kron as tk

    card = cs.card_info()
    g = torch.Generator(device="cpu").manual_seed(0)
    for label, sizes, fn, kw in [
        ("K2 32^5 default", (32,) * 5, tk.kron_matvec_slab, dict(precision="default", mid_dtype=torch.bfloat16)),
        ("K2 32^5 highest", (32,) * 5, tk.kron_matvec_slab, dict(precision="highest")),
        ("K3 8x512x512 highest", (8, 512, 512), tk.kron_matvec_fused, dict(precision="highest")),
    ]:
        fs = [(torch.randn((m, m), generator=g) / m**0.5).cuda() for m in sizes]
        v = torch.randn((int(torch.tensor(sizes).prod()), 1), generator=g).cuda()
        for _ in range(3):
            fn(fs, v, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(fs, v, **kw)
            torch.cuda.synchronize()
        total, items = _device_items(prof)
        print(json.dumps({"profile": label, "plan": tk._hopper_plan(list(sizes), list(sizes), 1),
                          "device_ms_per_call": total / 10, "items": items, "card": card}), flush=True)

    for name in cs.GRID_CONFIGS:
        xg, y = cs.grid_data(name)
        model = cs.grid_model(name, xg, y, torch.float32, "cuda")
        model.log_likelihood()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.log_likelihood()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        total, items = _device_items(prof)
        print(json.dumps({"profile": f"{name} CG log_likelihood", "wall_ms": wall * 1e3, "device_ms": total,
                          "idle_share": 1 - total / (wall * 1e3), "cg_iterations": model.cg_info.iterations,
                          "items": items, "card": card}), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
