#!/usr/bin/env python3
"""Which collectives each ``torch.distributed`` backend carries on CUDA
tensors when every rank sits on one card, and the time of one 36 MB
``all_reduce`` (a (9, 32⁴) float32 SKI lattice block).

    python3 tools/dist_probe.py        # on a machine with a CUDA device

Runs gloo at world 2 and NCCL at world 1 and world 2 (all ranks on
``cuda:0`` when there is one card), through ``gp_grief_tpu_torch.parallel``'s
collectives, and prints one JSON line per launch (or the failure).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def probe():
    from gp_grief_tpu_torch.ops import collectives as C
    from gp_grief_tpu_torch.parallel import data_mesh

    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": torch.cuda.current_device()}
    g = data_mesh(device_type="cuda").get_group("data")
    w = dist.get_world_size()
    for name, fn in (("all_reduce", lambda: C.psum(torch.ones(4, device="cuda"), g)),
                     ("reduce_scatter", lambda: C.psum_scatter(torch.ones(4 * w, 3, device="cuda"), g)),
                     ("all_gather", lambda: C.all_gather(torch.ones(2, 3, device="cuda"), g))):
        try:
            r = fn()
            torch.cuda.synchronize()
            out[name] = r.sum().item()
        except Exception as e:  # the backend's refusal is the finding
            out[name] = f"error {type(e).__name__}: {str(e)[:200]}"
    t = torch.ones(9 * 32**4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        C.psum(t, g)
    torch.cuda.synchronize()
    out["all_reduce_36MB_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    return out


def main() -> int:
    from gp_grief_tpu_torch.parallel.launch import spawn

    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    for world, backend in ((2, "gloo"), (1, "nccl"), (2, "nccl")):
        try:
            res = spawn(probe, world, backend=backend, device="cuda", timeout=90)
            print(json.dumps({"world": world, "backend": backend, "ranks": res}), flush=True)
        except Exception as e:
            print(json.dumps({"world": world, "backend": backend, "failed": str(e)[-600:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
