"""GP-GRIEF at d = 100: a grid with 10^100 virtual inducing points.

Per-dimension kernels trained on the marginal likelihood with
``opt_kernel_params`` (ARD-style relevance: the lengthscales of the
irrelevant dimensions grow), a short phase because each step
differentiates the whole d-dimensional basis rebuild; then
``refresh_basis`` and a cheap O(p³) reweighting polish at the learned
hyperparameters (the port of ``examples/demo_grief_highdim.py``).

Run: ``python -m gp_grief_tpu_torch.examples.demo_grief_highdim [--d 100] [--n 2000] [--p 200]
[--ard-iters 25] [--device cpu]`` (on the card float32, ``--device cpu`` float64).
"""

from __future__ import annotations

import sys

import numpy as np

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.examples import _common as c


def run(d: int = 100, n: int = 2000, p: int = 200, ard_iters: int = 25, *, device: str = "cuda",
        recipe=None) -> dict:
    cpu = c.recipe_of(device, recipe) == "cpu"
    before, t0 = c.start(device)
    rng = np.random.default_rng(0)
    dtype = np.float64 if cpu else np.float32
    x = rng.uniform(0, 1, size=(n, d)).astype(dtype)
    # Sparse additive ground truth: only a few dimensions matter.
    y = (np.sin(4 * x[:, 0]) + 0.7 * np.cos(3 * x[:, 1]) + 0.3 * x[:, 2]
         + 0.05 * rng.standard_normal(n)).astype(dtype)

    grid = gpt.InducingGrid.build(x, mbar=10)
    out = {"d": d, "grid_pts": int(grid.grid_shape[0]), "log10_virtual": float(grid.log10_num_virtual)}
    kerns = [gpt.make_kernel("rbf", lengthscale=1.5) for _ in range(d)]
    model = gpt.GPGriefModel(x, y, kerns, grid, n_eigs=p, noise_var=0.1, dtype=c.torch_dtype(dtype), device=device,
                             opt_kernel_params=True, dim_noise_var=1e-8)
    out["ll_init"] = model.log_likelihood()
    res = model.optimize(optimizer="adam", max_iters=ard_iters, learning_rate=0.05)
    out.update(ll_ard=model.log_likelihood(), ard_iters=int(res.iterations), ard_s=res.wall_time)
    model.opt_kernel_params = False
    model.refresh_basis()
    res = model.optimize(optimizer="adam", max_iters=150, learning_rate=0.05)
    out.update(ll_polish=model.log_likelihood(), polish_iters=int(res.iterations), polish_s=res.wall_time)
    lengthscales = [float(k.lengthscale.detach()) for k in model.kernels]
    out["relevant"] = [i for _, i in sorted((v, i) for i, v in enumerate(lengthscales))[:5]]
    out["lengthscales"] = lengthscales

    xs = rng.uniform(0, 1, size=(500, d)).astype(dtype)
    f_true = np.sin(4 * xs[:, 0]) + 0.7 * np.cos(3 * xs[:, 1]) + 0.3 * xs[:, 2]
    mean = c.to_np(model.predict(xs, compute_var=False))
    out.update(rmse=float(np.sqrt(np.mean((mean - f_true) ** 2))), mean_finite=bool(np.isfinite(mean).all()),
               wall_s=c.clock(device) - t0, launches=c.since(before))
    return out


def lines(v: dict) -> list:
    return [f"grid: {v['d']} dims × {v['grid_pts']} pts = 10^{v['log10_virtual']:.0f} virtual inducing points",
            f"initial ll: {v['ll_init']:.2f}",
            f"after ARD phase ll: {v['ll_ard']:.2f} ({v['ard_iters']} iters, {v['ard_s']:.1f}s)",
            f"after reweight polish ll: {v['ll_polish']:.2f} ({v['polish_iters']} iters, {v['polish_s']:.1f}s)",
            f"most relevant dims (smallest lengthscales): {v['relevant']}",
            f"test RMSE vs truth: {v['rmse']:.4f}"]


def main(argv=None) -> int:
    ap = c.parser(__doc__)
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--p", type=int, default=200)
    ap.add_argument("--ard-iters", type=int, default=25,
                    help="opt_kernel_params Adam steps (each rebuilds and differentiates the whole basis)")
    args = ap.parse_args(argv)
    print("\n".join(lines(run(d=args.d, n=args.n, p=args.p, ard_iters=args.ard_iters, device=args.device))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
