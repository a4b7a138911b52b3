"""1D regression demo: the exact GP and GP-GRIEF on a noisy sine.

Fits GP-GRIEF (a 100-point grid, p = 10 eigenfunctions) and the exact GP by
Cholesky, trains each model's hyperparameters on its marginal likelihood
and prints train and test metrics side by side (the port of
``examples/demo_1d_regression.py``).

Run: ``python -m gp_grief_tpu_torch.examples.demo_1d_regression [--n 1000] [--device cpu]``
(on the card: float32 and Adam; ``--device cpu``: float64 and L-BFGS).
"""

from __future__ import annotations

import sys

import numpy as np

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.examples import _common as c


def run(n: int = 1000, *, device: str = "cuda", recipe=None) -> dict:
    cpu = c.recipe_of(device, recipe) == "cpu"
    before, t0 = c.start(device)
    rng = np.random.default_rng(0)
    dtype = np.float64 if cpu else np.float32
    x = rng.uniform(0, 4, size=(n, 1)).astype(dtype)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(dtype)
    xs = np.linspace(0, 4, 400)[:, None].astype(dtype)
    f_true = np.sin(2 * xs[:, 0])
    optimizer = "lbfgs" if cpu else "adam"

    # GP-GRIEF: 100-point grid, p = 10 eigenfunctions.
    grid = gpt.InducingGrid.build(x, mbar=100)
    grief = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.5)], grid, n_eigs=10, noise_var=0.5,
                             dtype=c.torch_dtype(dtype), device=device)
    grief_ll_init = grief.log_likelihood()
    res = grief.optimize(max_iters=100, optimizer=optimizer)
    gm, gv = (c.to_np(t) for t in grief.predict(xs))
    out = {"grief_ll": grief.log_likelihood(), "grief_rmse": float(np.sqrt(np.mean((gm - f_true) ** 2))),
           "grief_iters": int(res.iterations), "grief_s": res.wall_time, "grief_ll_init": grief_ll_init}

    # The exact GP oracle.
    sub = slice(0, min(n, 1000))
    exact = gpt.GPRegression(x[sub], y[sub], gpt.make_kernel("rbf", lengthscale=0.5), noise_var=0.5, device=device)
    exact_ll_init = exact.log_likelihood()
    res = exact.optimize(max_iters=50, optimizer=optimizer)
    em, ev = (c.to_np(t) for t in exact.predict(xs))
    out.update(exact_ll=exact.log_likelihood(), exact_rmse=float(np.sqrt(np.mean((em - f_true) ** 2))),
               exact_iters=int(res.iterations), exact_s=res.wall_time, mean_gap=float(np.abs(gm - em).mean()),
               exact_ll_init=exact_ll_init, grief_var_min=float(gv.min()), exact_var_min=float(ev.min()),
               mean_finite=bool(np.isfinite(gm).all() and np.isfinite(em).all()))
    out.update(wall_s=c.clock(device) - t0, launches=c.since(before))
    return out


def lines(v: dict) -> list:
    return [f"GP-GRIEF : ll={v['grief_ll']:10.2f}  rmse={v['grief_rmse']:.4f}  "
            f"({v['grief_iters']} iters, {v['grief_s']:.1f}s)",
            f"exact GP : ll={v['exact_ll']:10.2f}  rmse={v['exact_rmse']:.4f}  "
            f"({v['exact_iters']} iters, {v['exact_s']:.1f}s)",
            f"mean abs predictive-mean gap GRIEF vs exact: {v['mean_gap']:.5f}"]


def main(argv=None) -> int:
    ap = c.parser(__doc__)
    ap.add_argument("--n", type=int, default=1000)
    args = ap.parse_args(argv)
    print("\n".join(lines(run(n=args.n, device=args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
