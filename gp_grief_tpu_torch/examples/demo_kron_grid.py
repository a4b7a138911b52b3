"""The exact GP on a grid (Kronecker algebra): ``GPKroneckerRegression``.

1. the exact NLML and its training on a full Cartesian lattice (40³) through
   per-dimension eigendecompositions, never O(m³);
2. prediction at scattered points off the grid (Khatri-Rao
   cross-covariances), with variances;
3. grouped grid dimensions: one grid axis spanning two input columns;
4. model parallelism: ``mesh=`` shards every CG matvec's lattice over
   ``--world`` ranks (one process each; ``--world 1`` skips it).

The port of ``examples/demo_kron_grid.py``.  That script fixes no dtype:
JAX runs it in float32 unless float64 is enabled.  Here the card runs
float32 and ``--device cpu`` float64 (the JAX package's tests enable it);
``dtype=`` sets either.

Run: ``python -m gp_grief_tpu_torch.examples.demo_kron_grid [--world 2] [--device cpu]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.examples import _common as c


def _mesh_rank(xg, y, dtype, device: str, rank_init) -> dict:
    """One rank of section 4: the model-parallel CG NLML on a
    (world // 2, 2) ("data", "model") mesh."""
    from gp_grief_tpu_torch import parallel as par

    before = c.rank_start(device, rank_init)
    mesh = par.make_mesh((torch.distributed.get_world_size() // 2, 2), ("data", "model"), device_type=device)
    model = gpt.GPKroneckerRegression(xg, y, [gpt.make_kernel("matern52", lengthscale=0.3) for _ in range(3)],
                                      noise_var=0.1, solver="cg", mesh=mesh, dtype=dtype, device=device)
    nlml = model.log_likelihood()
    return {"nlml": nlml, "mesh": dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape))),
            "cg_iterations": int(model.cg_info.iterations), "launches": c.since(before), "peak_gb": c.peak_gb(device)}


def run(*, world: int = 2, device: str = "cuda", recipe=None, dtype=None, rank_init=None) -> dict:
    """``rank_init``: a picklable callable run first in each rank of section 4."""
    cpu = c.recipe_of(device, recipe) == "cpu"
    dtype = c.torch_dtype(dtype or (np.float64 if cpu else np.float32))
    before, t0 = c.start(device)
    rng = np.random.default_rng(0)

    # 1. The exact GP on a 40x40x40 lattice (64k points).
    xg = [np.linspace(0, 1, 40)[:, None] for _ in range(3)]
    g0, g1, g2 = np.meshgrid(*[g[:, 0] for g in xg], indexing="ij")
    f = np.sin(4 * g0) * np.cos(3 * g1) + 0.5 * g2
    y = (f + 0.05 * rng.standard_normal(f.shape)).reshape(-1)
    model = gpt.GPKroneckerRegression(xg, y, [gpt.make_kernel("matern52", lengthscale=0.3) for _ in range(3)],
                                      noise_var=0.1, dtype=dtype, device=device)
    out = {"m": int(model.m), "nlml": model.log_likelihood()}
    res = model.optimize(optimizer="adam", max_iters=60, learning_rate=0.1)
    out.update(nlml_trained=model.log_likelihood(), train_s=res.wall_time, params=model.parameters.tolist())

    # 2. Scattered-point prediction off the grid.
    xs = rng.uniform(0.05, 0.95, size=(500, 3))
    fs = np.sin(4 * xs[:, 0]) * np.cos(3 * xs[:, 1]) + 0.5 * xs[:, 2]
    mean, var = (c.to_np(t) for t in model.predict(xs))
    out.update(rmse=float(np.sqrt(np.mean((mean - fs) ** 2))), var_min=float(var.min()), var_max=float(var.max()),
               mean_finite=bool(np.isfinite(mean).all()))

    # 3. Grouped dimensions: one 2-column spatial grid axis.
    xg2 = [np.linspace(0, 1, 12)[:, None], rng.uniform(0, 1, size=(30, 2))]
    y2 = rng.standard_normal(12 * 30)
    grouped = gpt.GPKroneckerRegression(
        xg2, y2, [gpt.make_kernel("rbf", lengthscale=0.4), gpt.make_kernel("rbf", lengthscale=0.5, input_dim=2)],
        noise_var=0.3, dtype=dtype, device=device)
    out.update(grouped_dims=[list(cols) for cols in grouped.dims], grouped_nlml=grouped.log_likelihood())
    mg, vg = (c.to_np(t) for t in grouped.predict(rng.uniform(0, 1, size=(5, 3))))
    out.update(grouped_mean=[float(v) for v in mg[:3]], grouped_var_min=float(vg.min()))
    counts = [c.since(before)]

    # 4. Model parallelism (needs >= 2 ranks).
    out["mesh"] = None
    if world >= 2 and world % 2 == 0:
        from gp_grief_tpu_torch.parallel.launch import spawn

        ranks = spawn(_mesh_rank, world, args=(xg, y, dtype, torch.device(device).type, rank_init),
                      device=torch.device(device).type, backend=c.backend_for(device, world))
        out.update(mesh_nlml=ranks[0]["nlml"], mesh=ranks[0]["mesh"], mesh_cg_iterations=ranks[0]["cg_iterations"],
                   mesh_nlml_ranks=[r["nlml"] for r in ranks], rank_peak_gb=[r["peak_gb"] for r in ranks])
        counts += [r["launches"] for r in ranks]
    out.update(wall_s=c.clock(device) - t0, launches=c.summed(counts))
    return out


def lines(v: dict, world: int = 2) -> list:
    out = [f"lattice m = {v['m']}  NLML = {v['nlml']}", f"after training NLML = {v['nlml_trained']}",
           f"off-grid predict rmse = {v['rmse']:.4f}  (noise floor 0.05), "
           f"var in [{v['var_min']:.2e}, {v['var_max']:.2e}]",
           f"grouped dims: {tuple(tuple(cols) for cols in v['grouped_dims'])}  NLML = {v['grouped_nlml']}",
           f"grouped predict mean[:3] = {np.round(np.asarray(v['grouped_mean']), 3)}"]
    if v["mesh"] is not None:
        out.append(f"model-parallel CG NLML = {v['mesh_nlml']}  (mesh: {v['mesh']} )")
    elif world < 2:
        out.append("single device — skipping the model-parallel section")
    return out


def main(argv=None) -> int:
    ap = c.parser(__doc__)
    ap.add_argument("--world", type=int, default=2, help="ranks of section 4's mesh (1: skip it)")
    args = ap.parse_args(argv)
    v = run(world=args.world, device=args.device)
    print("\n".join(lines(v, args.world)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
