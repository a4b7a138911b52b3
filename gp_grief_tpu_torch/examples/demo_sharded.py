"""Data-parallel GP-GRIEF and SKI over ranks of ``torch.distributed``.

Each rank (one process, ``gp_grief_tpu_torch.parallel.launch.spawn``)
builds its Φ block from its own rows, and the p×p statistics are summed
over the ranks: the same API as the one-device ``GPGriefModel``.  Then
``ShardedGPSKIRegression``: per-rank interpolation plans, CG and SLQ
coupled by sums over the ranks (the port of ``examples/demo_sharded.py``,
whose mesh is every JAX device; here ``--world`` ranks: gloo on the CPU
and where ranks share a card, NCCL across cards).

Run: ``python -m gp_grief_tpu_torch.examples.demo_sharded [--world 2] [--device cpu]``
(float32, as the script; ``dtype=`` in :func:`run`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.examples import _common as c


def _rank(device: str, dtype, rank_init) -> dict:
    """One rank: the whole demo, SPMD (every rank builds the models from the
    same data and keeps its rows)."""
    from gp_grief_tpu_torch import parallel as par

    before = c.rank_start(device, rank_init)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    rng = np.random.default_rng(0)
    n, d = 4000, 3
    x = rng.uniform(0, 1, size=(n, d)).astype(np_dtype)
    y = (np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2]
         + 0.05 * rng.standard_normal(n)).astype(np_dtype)

    model = par.ShardedGPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.4) for _ in range(d)],
                                    n_eigs=64, mbar=12, noise_var=0.2, dtype=dtype, device=device)
    out = {"device": str(dev), "rows": int(model.x.shape[0]), "ll_init": model.log_likelihood()}
    res = model.optimize(optimizer="adam", max_iters=100, learning_rate=0.05)
    out.update(ll=model.log_likelihood(), iters=int(res.iterations), train_s=res.wall_time)

    xs = rng.uniform(0.1, 0.9, size=(400, d)).astype(np_dtype)
    truth = np.sin(4 * xs[:, 0]) * np.cos(3 * xs[:, 1]) + 0.5 * xs[:, 2]
    mean = c.to_np(model.predict(xs, compute_var=False))
    out.update(rmse=float(np.sqrt(np.mean((mean - truth) ** 2))), mean_finite=bool(np.isfinite(mean).all()))

    # Data-parallel SKI: per-rank interpolation plans, CG and SLQ coupled by sums.
    ski = par.ShardedGPSKIRegression(x[:, :2], y, gpt.make_kernel("rbf", lengthscale=0.4), mbar=10, noise_var=0.2,
                                     num_probes=16, lanczos_iters=30, cg_iters=300, cg_tol=1e-8, precond_rank=64,
                                     dtype=dtype, device=device)
    out["ski_ll"] = ski.log_likelihood()
    mean_s, var_s = (c.to_np(t) for t in ski.predict(xs[:, :2][:100]))
    out.update(ski_mean=[float(v) for v in mean_s], ski_var=[float(v) for v in var_s],
               ski_cg_iterations=int(ski.cg_info.iterations), launches=c.since(before), peak_gb=c.peak_gb(device))
    return out


def run(*, world: int = 2, device: str = "cuda", dtype=np.float32, rank_init=None) -> dict:
    """Rank 0's values, every rank's device, and the ranks' summed launches;
    ``rank_init``: a picklable callable run first in each rank."""
    from gp_grief_tpu_torch.parallel.launch import spawn

    kind = torch.device(device).type
    t0 = c.start(device)[1]
    ranks = spawn(_rank, world, args=(kind, c.torch_dtype(dtype), rank_init), device=kind,
                  backend=c.backend_for(device, world))
    out = dict(ranks[0])
    out.update(devices=[r["device"] for r in ranks], rows=[r["rows"] for r in ranks],
               ski_ll_ranks=[r["ski_ll"] for r in ranks], rank_peak_gb=[r["peak_gb"] for r in ranks],
               wall_s=c.clock(device) - t0,
               launches=c.summed(r["launches"] for r in ranks))
    for key in ("device", "peak_gb"):
        del out[key]
    return out


def lines(v: dict) -> list:
    return [f"devices: {v['devices']}", f"initial ll: {v['ll_init']:.2f}",
            f"optimized ll: {v['ll']:.2f} ({v['iters']} iters, {v['train_s']:.1f}s)",
            f"test RMSE: {v['rmse']:.4f}", f"sharded SKI ll: {v['ski_ll']:.2f}",
            f"sharded SKI predict: mean[0]={v['ski_mean'][0]:.3f} var range "
            f"[{min(v['ski_var']):.3e}, {max(v['ski_var']):.3e}]"]


def main(argv=None) -> int:
    ap = c.parser(__doc__)
    ap.add_argument("--world", type=int, default=2, help="ranks (processes)")
    args = ap.parse_args(argv)
    print("\n".join(lines(run(world=args.world, device=args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
