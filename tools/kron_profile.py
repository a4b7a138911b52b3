#!/usr/bin/env python3
"""Device time of the Kronecker pass kernels at chip_smoke.py's shapes, and
of the grid configurations' CG log-likelihood (PERF.md §5-6).

Usage, from the repository root, on a machine with a CUDA device:

    python3 tools/kron_profile.py [--reps 20] [--only SUBSTRING ...]

For each case of chip_smoke.py's phase 6 (K2, K3) and phase 10 (K6, K7, K8)
and each of its grades, the entry point runs ``reps`` times under
``torch.profiler``; one JSON line gives the CUDA-event median of a call
(``cuda_ms``, as chip_smoke times it), the host's time to enqueue one call
(``host_us``), the profiler's device time of each kernel per call
(``kernels``, keyed by the kernel's template name) and the card's name and
power limit.  Then, for each grid configuration of chip_smoke.GRID_CONFIGS,
one CG log-likelihood after a warm-up: wall time, device time, idle share
and its ten largest device items.  ``--only`` keeps the cases and
configurations whose label or entry-point name contains one of the
substrings.  Run only when named by ``--only``: ``interp_wt`` / ``wtw_stencil``
(K4 / K5 at phase 8's float32 shapes), ``phi_fused`` (K1 at phase 3's
float32 shapes), a SKI configuration's name (its float32 NLML after a first
call, profiled as the grid configurations' are) and ``uci2m`` (uci2m_synth's
model build with its chunked statistics, profiled).  The kernels are built
from the checkout's csrc/ at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _short(name: str) -> str:
    """``void (anonymous namespace)::kron_wide_kernel<true, ...>(...)`` ->
    ``kron_wide_kernel<true, ...>``."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth, end = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            end = i
            break
    return name[:end]


def _device_us(evt) -> float:
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, key):
            return float(getattr(evt, key))
    return 0.0


def profile(fn, reps: int) -> dict:
    """Per-call device time (ms) of every kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type.name == "CUDA":
            out[_short(evt.key)] = out.get(_short(evt.key), 0.0) + us / reps / 1e3
    return out


def host_time(fn, reps: int) -> float:
    """Host seconds to enqueue one call (no synchronisation inside the
    window; ``reps`` calls stay far below the launch queue's depth)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps


def cases():
    """(label, entry name, precisions, factor shapes (o, m), B, lead, make input, run(x, precision))."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk

    out = []
    for kname, label, sizes, B in chip_smoke.KRON_SHAPES:
        fn = tk.kron_matvec_slab if kname == "kron_slab" else tk.kron_matvec_fused
        M = int(np.prod(sizes))
        g = torch.Generator(device="cpu").manual_seed(0)
        fs = [(torch.randn((m, m), generator=g) / m**0.5).cuda() for m in sizes]

        def run(x, p, fn=fn, fs=fs, slab=kname == "kron_slab"):
            kw = {"mid_dtype": torch.bfloat16} if slab and p == "default" else {}
            return fn(fs, x, precision=p, **kw)

        out.append((label, kname, ["highest", "default"], [(m, m) for m in sizes], B, 1, (M, B), run))
    for label, kname, shape, precisions, fshapes, lead, B, run, *_ in chip_smoke.axes_cases():
        out.append((label, kname, precisions, fshapes, B, lead, shape, run))
    return out


def ski_cases():
    """(label, entry name, run()) for K4 and K5 at chip_smoke.py's phase-8
    shapes, float32, through their public entry points."""
    import torch
    from gp_grief_tpu_torch.ops import interp as tint
    from gp_grief_tpu_torch.ops import interp_stencil as tst
    from gp_grief_tpu_torch.ops.cuda import interp_wt, wtw_stencil

    for kname, label, which, B in chip_smoke.SKI_KERNEL_SHAPES:
        x, xg = chip_smoke.ski_geometry(which)
        iw = tint.interp_weights(x, xg)
        g = torch.Generator(device="cpu").manual_seed(0)
        if kname == "interp_wt":
            plan = tint.build_interp_plan(iw, dtype=torch.float32, device="cuda")
            u = torch.randn((B, int(x.shape[0])), generator=g).cuda()
            yield label, kname, lambda plan=plan, u=u: interp_wt(plan, u)
        else:
            st = tst.build_wtw_stencil(iw, dtype=torch.float32, device="cuda")
            v = torch.randn((B, st.M), generator=g).cuda()
            yield label, kname, lambda st=st, v=v: wtw_stencil(st, v)


def phi_cases():
    """(label, run()) for K1 at chip_smoke.py's phase-3 shapes, float32."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import phi_fused

    for name, d, n, m, p in chip_smoke.KERNEL_SHAPES:
        with torch.no_grad():
            B, S = chip_smoke.phi_operands(d, n, m, p, torch.float32, "cuda")
        yield name, lambda B=B, S=S: phi_fused(B, S)


def profile_call(label: str, fn, card: str, extra=dict) -> None:
    """One call of ``fn`` under the profiler: wall, device time, idle share,
    the ten largest device items and ``extra()``'s keys."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, items = chip_smoke.device_items(prof)
    print(json.dumps({"profile": label, "wall_ms": wall * 1e3, "device_ms": total,
                      "idle_share": 1 - total / (wall * 1e3), **extra(), "items": items, "card": card}), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kron_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_info()
    from gp_grief_tpu_torch.ops.cuda import kron as tk

    for label, kname, precisions, fshapes, B, lead, shape, run in cases():
        if args.only and not any(s in label or s in kname for s in args.only):
            continue
        x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
        sizes, outs = [s[1] for s in fshapes], [s[0] for s in fshapes]
        plan = [(0, 0, 0)] if kname == "last_slab_pass" else tk._hopper_plan(sizes, outs, B)
        for precision in precisions:
            with torch.no_grad():
                ms = chip_smoke.cuda_ms(lambda: run(x, precision), reps=args.reps)
                kernels = profile(lambda: run(x, precision), args.reps)
                host_us = host_time(lambda: run(x, precision), args.reps) * 1e6
            print(json.dumps({"case": label, "kernel": kname, "precision": precision, "plan": plan, "lead": lead,
                              "cuda_ms": ms, "host_us": host_us, "kernels": kernels, "card": card}), flush=True)
        del x
        torch.cuda.empty_cache()

    if args.only and any(s in k for s in args.only for k in ("interp_wt", "wtw_stencil")):
        for label, kname, run in ski_cases():
            if not any(s in label or s in kname for s in args.only):
                continue
            with torch.no_grad():
                ms = chip_smoke.cuda_ms(run, reps=args.reps)
                kernels = profile(run, args.reps)
                host_us = host_time(run, args.reps) * 1e6
            print(json.dumps({"case": label, "kernel": kname, "precision": "float32", "cuda_ms": ms,
                              "host_us": host_us, "kernels": kernels, "card": card}), flush=True)

    if args.only and "phi_fused" in args.only:
        for label, run in phi_cases():
            with torch.no_grad():
                ms = chip_smoke.cuda_ms(run, reps=args.reps)
                kernels = profile(run, args.reps)
                host_us = host_time(run, args.reps) * 1e6
            print(json.dumps({"case": label, "kernel": "phi_fused", "precision": "float32", "cuda_ms": ms,
                              "host_us": host_us, "kernels": kernels, "card": card}), flush=True)

    for name in chip_smoke.SKI_CONFIGS:
        if not (args.only and name in args.only):
            continue
        x, y, xg = chip_smoke.ski_data(name)
        model = chip_smoke.ski_model(name, x, y, xg, torch.float32)
        model.log_likelihood()  # builds the plans
        profile_call(f"{name} float32 log_likelihood", model.log_likelihood, card)
        del model
        torch.cuda.empty_cache()

    if args.only and "uci2m" in args.only:
        xtr, ytr, _, _ = chip_smoke.uci2m_data()
        build = lambda: chip_smoke.uci2m_build(xtr, ytr)  # noqa: E731
        build()  # warm-up: the first build pays for the library load and the allocator
        profile_call("uci2m_synth model build and chunked statistics", build, card)
        torch.cuda.empty_cache()

    for name in chip_smoke.GRID_CONFIGS:
        if args.only and not any(s in name for s in args.only):
            continue
        xg, y = chip_smoke.grid_data(name)
        model = chip_smoke.grid_model(name, xg, y, torch.float32, "cuda")
        model.log_likelihood()  # warm-up
        profile_call(f"{name} CG log_likelihood", model.log_likelihood, card,
                     lambda: {"cg_iterations": model.cg_info.iterations})
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
