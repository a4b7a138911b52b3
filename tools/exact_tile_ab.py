#!/usr/bin/env python3
"""Time the exact grade's Kronecker tile passes of one tree of this repo.

Usage, on a machine with a CUDA device:

    python3 tools/exact_tile_ab.py [TREE] [--reps 20] [--only LABEL ...]

TREE (default: this repository) is the root of a checkout whose
``gp_grief_tpu_torch`` is imported and whose kernels are built; for a
parent/change comparison unpack the parent with ``git archive`` into a
directory that ``.gitignore`` lists and run this script on both trees in
turns (parent, change, change, parent) in one call.

For each case, the "highest" grade of the entry point a caller uses (K2, X3,
K3, K7, K8 at chip_smoke.py's phase-6 and phase-10 shapes), one JSON line:
the CUDA-event median of a call over distinct inputs (``ms``, as chip_smoke
times it), the profiler's device time per call of each kernel template
(``kernels``) and of the whole call (``device_ms``), the bound (bytes or
3xTF32 operations, as chip_smoke's ``kron_bound``), and the sha256 of the
float32 output for a fixed input (``digest``; X3's is the input of
tests/test_torch_kron_cuda.py's ``X3_DIGEST``): two trees that keep the exact
grade's bits print the same digests.  The card's name and power limit come
with each line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

H100_BYTES_PER_S = 3.35e12
HIGHEST_FLOPS = 495e12 / 3


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def bound_ms(sizes, outs, B, lead=1):
    nbytes = 4 * (lead * B * (int(np.prod(sizes)) + int(np.prod(outs))) + sum(o * m for o, m in zip(outs, sizes)))
    ops = 2.0 * lead * B * sum(int(np.prod(sizes[:t])) * outs[t] * sizes[t] * int(np.prod(outs[t + 1:]))
                               for t in range(len(sizes)))
    tb, to = nbytes / H100_BYTES_PER_S, ops / HIGHEST_FLOPS
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def short(name: str) -> str:
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def cases(torch, tk, ka, fast_matvec):
    """(label, factor shapes (o, m), B, lead, input shape, run(x), fixed input for the digest or None)."""
    rng = np.random.default_rng(0)

    def mats(shapes, scale=2.2):
        return [torch.as_tensor((rng.standard_normal(s) / (scale * np.sqrt(s[1]))).astype(np.float32)).cuda()
                for s in shapes]

    K32 = mats([(32, 32)] * 5)
    rect = mats([(96, 80), (24, 32), (40, 32)], scale=1.0)
    g = torch.Generator().manual_seed(4)
    Qs = [torch.linalg.qr(torch.randn((32, 32), generator=g, dtype=torch.float64))[0].float().contiguous().cuda()
          for _ in range(4)]
    X3 = [torch.eye(8).cuda(), *Qs]
    # X3's fixed input: tests/test_torch_kron_cuda.py's, so its digest is X3_DIGEST there.
    x3_in = torch.randn((8 * 32**4,), generator=g, dtype=torch.float64).float().cuda()
    K8 = mats([(8, 8), (512, 512), (512, 512)])
    M = 32**5
    out = [
        ("k2_32x5_B1", [(32, 32)] * 5, 1, 1, (M, 1), lambda x: tk.kron_matvec_slab(K32, x, precision="highest")),
        ("x3_I8_32x4", [(8, 8)] + [(32, 32)] * 4, 1, 1, (8 * 32**4,),
         lambda x: fast_matvec(X3, x, precision="BF16_BF16_F32_X3")),
        ("k3_8x512x512", [(8, 8), (512, 512), (512, 512)], 1, 1, (8 * 512 * 512, 1),
         lambda x: tk.kron_matvec_fused(K8, x, precision="highest")),
        ("k7_32x5_B1", [(32, 32)] * 5, 1, 1, (M,), lambda x: ka.kron_matmat_cuda(K32, x, precision="highest")),
        ("k7_32x5_B8", [(32, 32)] * 5, 8, 1, (M, 8), lambda x: ka.kron_matmat_cuda(K32, x, precision="highest")),
        ("k7_rect_96x80_24x32_40x32_B8", [(96, 80), (24, 32), (40, 32)], 8, 1, (80 * 32 * 32, 8),
         lambda x: ka.kron_matmat_cuda(rect, x, precision="highest")),
        ("k8_tail3_1024", [(32, 32)] * 3, 1, 1024, (1024, 32, 32, 32),
         lambda x: ka.tail3_pass(x, *K32[2:], precision="highest")),
        ("k8_tail2_32768", [(32, 32)] * 2, 1, 32768, (32768, 32, 32),
         lambda x: ka.tail2_pass(x, *K32[3:], precision="highest")),
        # K2's second pass at 32^5 alone (its first is tail3's): axes 0-1, 32768 columns.
        ("k2_second_pass", [(32, 32)] * 2, 32768, 1, (32 * 32, 32768),
         lambda x: tk._launch(tk.kron_matvec_fused, K32[:2], x, False, None, 32768, plan=((0, 1, 32),))),
    ]
    return [(*c, x3_in if c[0].startswith("x3") else None) for c in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None, help="cases whose label contains one of these")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("exact_tile_ab: no CUDA device", file=sys.stderr)
        return 1
    import gp_grief_tpu_torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk
    from gp_grief_tpu_torch.ops.cuda import kron_axes as ka
    from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast

    assert os.path.dirname(os.path.dirname(os.path.abspath(gp_grief_tpu_torch.__file__))) == tree
    torch.backends.cuda.matmul.allow_tf32 = False
    info = card()
    for label, fshapes, B, lead, shape, run, fixed in cases(torch, tk, ka, kron_matvec_fast):
        if args.only and not any(s in label for s in args.only):
            continue
        n_in = int(np.prod(shape))
        nv = max(1, -(-(128 << 20) // (4 * n_in)))  # distinct inputs: >= 128 MB, not timed from L2
        gen = torch.Generator(device="cuda").manual_seed(0)
        xs = [torch.randn(shape, generator=gen, device="cuda") for _ in range(nv)]
        with torch.no_grad():
            out = run(xs[0] if fixed is None else fixed)
            torch.cuda.synchronize()
            digest = hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()
            for _ in range(3):
                run(xs[0])
            it = iter(range(1 << 30))
            times = []
            for _ in range(args.reps):
                x = xs[next(it) % nv]
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                run(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    run(xs[next(it) % nv])
                torch.cuda.synchronize()
        kernels = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            if us > 0 and str(evt.device_type).endswith("CUDA"):
                key = short(evt.key)
                kernels[key] = kernels.get(key, 0.0) + us / args.reps / 1e3
        bms, by = bound_ms([s[1] for s in fshapes], [s[0] for s in fshapes], B, lead)
        print(json.dumps({"case": label, "tree": tree, "precision": "highest", "ms": float(np.median(times)),
                          "device_ms": sum(kernels.values()), "kernels": kernels, "bound_ms": bms, "bound_by": by,
                          "digest": digest, "distinct_inputs": nv, "card": info}), flush=True)
        del xs, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
