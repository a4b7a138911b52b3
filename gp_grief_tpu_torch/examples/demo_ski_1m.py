"""SKI / KISS-GP on one million scattered points.

1. ``GPSKIRegression(solver="lattice", train_mixed16=True)`` on a d = 4,
   32⁴ inducing lattice (M = 1,048,576 grid points, about n);
2. training by ``optimize_segmented``: bf16 CG state and bf16 Kronecker
   inputs in the whitened lattice dual;
3. the true NLML (working-precision solves, segmented SLQ log-det);
4. the predictive mean and exact variances at held-out points
   (whitened-dual CG).

Variances are clamped at ≥ 0: at about one point per grid cell the latent
variance sits below float32 resolution, so the minimum may print as
exactly 0 (the port of ``examples/demo_ski_1m.py``).  Smaller, or on the
CPU: ``--n 100000 --ms 16`` (``--device cpu``'s defaults).

Run: ``python -m gp_grief_tpu_torch.examples.demo_ski_1m [--n 1000000] [--ms 32] [--steps 20]
[--n-test 2000] [--device cpu]`` (float32, as the script; ``dtype=`` in :func:`run`).
"""

from __future__ import annotations

import sys

import numpy as np

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.examples import _common as c


def f_true(x):
    return np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3]


def run(n=None, ms=None, steps: int = 20, n_test: int = 2000, *, device: str = "cuda", recipe=None,
        dtype=np.float32, verbose: bool = False) -> dict:
    cpu = c.recipe_of(device, recipe) == "cpu"
    n, ms = n or (100_000 if cpu else 1_000_000), ms or (16 if cpu else 32)
    before, t_all = c.start(device)
    d = 4
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(n, d)).astype(dtype)
    y = (f_true(x) + 0.05 * rng.standard_normal(n)).astype(dtype)
    xg = [np.linspace(-0.05, 1.05, ms, dtype=dtype)[:, None]] * d

    t0 = c.clock(device)
    model = gpt.GPSKIRegression(x, y, [gpt.make_kernel("rbf", lengthscale=0.3) for _ in range(d)], xg,
                                noise_var=0.05, solver="lattice", train_mixed16=True, num_probes=8,
                                lanczos_iters=30, cg_iters=300, cg_tol=1e-6, dtype=c.torch_dtype(dtype),
                                device=device)
    out = {"n": n, "ms": ms, "d": d, "build_s": c.clock(device) - t0, "ll_init": model.log_likelihood()}

    t0 = c.clock(device)
    res = model.optimize_segmented(max_iters=steps, learning_rate=0.05, num_probes=8, verbose=verbose)
    out.update(steps=steps, train_s=c.clock(device) - t0, losses=[float(v) for v in res.losses])

    t0 = c.clock(device)
    ll = model.log_likelihood_segmented()
    out.update(nlml=-float(ll), nlml_s=c.clock(device) - t0)

    xs = rng.uniform(0.05, 0.95, size=(n_test, d)).astype(dtype)
    t0 = c.clock(device)
    mean, var = (c.to_np(t) for t in model.predict(xs))
    noise_var = float(np.exp(float(model.log_noise.detach())))
    rmse = float(np.sqrt(np.mean((mean - f_true(xs)) ** 2)))
    cal = float(np.mean(np.abs(mean - f_true(xs)) <= 2 * np.sqrt(var + noise_var)))
    out.update(n_test=n_test, predict_s=c.clock(device) - t0, rmse=rmse, var_min=float(var.min()),
               var_max=float(var.max()), coverage=cal, noise_var=noise_var,
               mean_finite=bool(np.isfinite(mean).all()), wall_s=c.clock(device) - t_all, launches=c.since(before))
    if not (rmse < 0.05 and var.min() >= 0 and var.max() > 0):
        raise AssertionError(f"demo_ski_1m: rmse {rmse} (< 0.05), variances in [{var.min()}, {var.max()}] "
                             "(>= 0, not all 0)")
    return out


def lines(v: dict) -> list:
    return [f"build: n={v['n']:,}, lattice {v['ms']}^{v['d']} (M={v['ms']**v['d']:,}) in {v['build_s']:.1f} s",
            f"train: {v['steps']} Adam steps in {v['train_s']:.1f} s "
            f"(surrogate {v['losses'][0]:.0f} -> {v['losses'][-1]:.0f})",
            f"true NLML: {v['nlml']:.1f} in {v['nlml_s']:.1f} s",
            f"predict: {v['n_test']} points in {v['predict_s']:.1f} s — rmse {v['rmse']:.4f}, var range "
            f"[{v['var_min']:.2e}, {v['var_max']:.2e}], 2σ coverage {v['coverage']:.3f}",
            "OK"]


def main(argv=None) -> int:
    ap = c.parser(__doc__)
    ap.add_argument("--n", type=int, default=None, help="points (1,000,000 on the card, 100,000 on the CPU)")
    ap.add_argument("--ms", type=int, default=None, help="grid points per dim (32 on the card, 16 on the CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n-test", type=int, default=2000)
    args = ap.parse_args(argv)
    v = run(n=args.n, ms=args.ms, steps=args.steps, n_test=args.n_test, device=args.device,
            verbose=True)
    print("\n".join(lines(v)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
