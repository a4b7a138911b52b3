"""One small sharded step of every parallel path, on ranks it spawns.

Counterpart of ``__graft_entry__.dryrun_multichip``: a GP-GRIEF training
step (on a 2-D ``(data, model)`` mesh when the world is even, the
per-dimension ``eigh`` split over ``model``), one ``ShardedGPSKIRegression``
lattice NLML and Adam step, its segmented NLML and step, and one
``GPKroneckerRegression(mesh=)`` NLML, each checked finite, at tiny shapes.

    python -m gp_grief_tpu_torch.parallel.dryrun 2                           # 2 ranks on the cards, NCCL
    python -m gp_grief_tpu_torch.parallel.dryrun 2 --backend gloo            # 2 ranks sharing one card
    python -m gp_grief_tpu_torch.parallel.dryrun 4 --device cpu              # 4 CPU ranks, gloo
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def _rank(device: str) -> dict:
    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch import parallel as par
    from gp_grief_tpu_torch.kernels.grid import cov_grid
    from gp_grief_tpu_torch.kernels.grief import GriefBasis
    from gp_grief_tpu_torch.models.base import basis_nlml
    from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs

    if device == "cpu":
        torch.set_num_threads(1)
    world = dist.get_world_size()
    two_d = world % 2 == 0 and world >= 4
    mesh = (par.make_mesh((world // 2, 2), ("data", "model"), device_type=device) if two_d
            else par.make_mesh((world,), ("data",), device_type=device))
    out = {"world": world, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    dtype = torch.float32
    rng = np.random.default_rng(0)

    # GP-GRIEF: split eigh + sharded stats + gradient + Adam, two steps.
    n, d, p = 16 * world, 4, 16
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    grid = gpt.InducingGrid.build(x, mbar=8)
    xg = tuple(torch.as_tensor(g, dtype=dtype, device=device) for g in grid.xg)
    kerns = [gpt.make_kernel("rbf", lengthscale=0.4, dtype=dtype, device=device) for _ in range(d)]
    log_w = torch.zeros(p, dtype=dtype, device=device, requires_grad=True)
    log_noise = torch.tensor(-1.0, dtype=dtype, device=device, requires_grad=True)
    data_size = par.collectives.axis_size(mesh, "data")
    xp, mask = par.pad_to_multiple(x, data_size)
    yp, _ = par.pad_to_multiple(y, data_size)
    params = [q for k in kerns for q in k.parameters()] + [log_w, log_noise]
    opt = torch.optim.Adam(params, lr=1e-2, eps=1e-8)
    values = []
    for _ in range(2):
        opt.zero_grad()
        Ks = torch.stack(cov_grid(kerns, xg, dim_noise_var=1e-5))
        if two_d:
            Qs, lams = par.stacked_eigh_sharded(Ks, mesh, "model")
        else:
            lams, Qs = torch.linalg.eigh(Ks)
        lams_t = tuple(lams[i] for i in range(d))
        log_lam, idx = top_p_kron_eigs(lams_t, p)
        basis = GriefBasis(Qs=tuple(Qs[i] for i in range(d)), lams=lams_t, log_lam=log_lam, idx=idx)
        stats = par.sharded_basis_stats(basis, kerns, xg, xp, yp, mask, mesh, n_real=n)
        value = basis_nlml(stats, log_w, log_noise)
        value.backward()
        opt.step()
        values.append(float(value.detach()))
    out["grief_nlml"] = values

    # SKI: the lattice dual's NLML and one Adam step; then segmented.
    ski_mesh = mesh if not two_d else par.make_mesh((world,), ("data",), device_type=device)
    n_ski = 32 * world
    xs = rng.uniform(0, 1, (n_ski, 2)).astype(np.float32)
    ys = (np.sin(3 * xs[:, 0]) + 0.5 * xs[:, 1] + 0.05 * rng.standard_normal(n_ski)).astype(np.float32)
    ski = par.ShardedGPSKIRegression(xs, ys, gpt.make_kernel("matern32", lengthscale=0.5), mbar=6, noise_var=0.1,
                                     solver="lattice", num_probes=2, lanczos_iters=6, cg_iters=30,
                                     mesh=ski_mesh, device=device)
    out["ski_nlml"] = -ski.log_likelihood()
    out["ski_step"] = float(ski.optimize(max_iters=1, optimizer="adam", learning_rate=0.05).losses[-1])
    out["ski_segmented_nlml"] = -ski.log_likelihood_segmented(cg_segment_iters=10, probe_chunk=2)
    out["ski_segmented_step"] = float(ski.optimize_segmented(max_iters=1, learning_rate=0.05, num_probes=2,
                                                             cg_segment_iters=10).losses[-1])

    # The grid model with its lattice's leading axis sharded.
    model_mesh = mesh if two_d else par.make_mesh((world,), ("model",), device_type=device)
    km = par.collectives.axis_size(model_mesh, "model")
    xg_k = [np.linspace(0, 1, m, dtype=np.float32)[:, None] for m in (4 * km, 6, 4)]
    yk = rng.standard_normal(4 * km * 24).astype(np.float32)
    grid_gp = gpt.GPKroneckerRegression(xg_k, yk, gpt.make_kernel("rbf", lengthscale=0.4), noise_var=0.1,
                                        solver="cg", cg_tol=1e-6, mesh=model_mesh, device=device)
    out["grid_nlml"] = -grid_gp.log_likelihood()
    bad = [k for k, v in out.items() if isinstance(v, float) and not np.isfinite(v)]
    bad += [k for k, v in out.items() if isinstance(v, list) and not np.all(np.isfinite(v))]
    if bad:
        raise FloatingPointError(f"dryrun: non-finite {bad}: {out}")
    return out


def dryrun_multichip(n_devices: int, *, device: str = "cuda", backend: str | None = None,
                     timeout: float = 600.0) -> dict:
    """Run the dry run on ``n_devices`` spawned ranks (``device`` ``"cuda"``:
    rank r on card r mod cards, NCCL by default; ``"cpu"``, the only way onto
    the CPU, with gloo) and return rank 0's values; every rank's must agree.
    Raises if a rank fails, a value is not finite, or the ranks disagree."""
    from gp_grief_tpu_torch.parallel.launch import spawn

    outs = spawn(_rank, int(n_devices), args=(device,), backend=backend, device=device, timeout=timeout)
    if any(o != outs[0] for o in outs[1:]):
        raise RuntimeError(f"dryrun: the ranks disagree: {outs}")
    return outs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n_devices, device=args.device, backend=args.backend)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
