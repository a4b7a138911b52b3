"""SKI / KISS-GP with refined ("mixed") CG.

Fits ``GPSKIRegression`` (scattered data tied to an inducing lattice by
linear interpolation) on a 2-D task twice: with exact CG and with
``cg_precision="mixed"`` (iterative refinement: the inner CG on the
Kronecker matvec at the "default" grade, K2's bf16 tensor-core member on
the card, with exact residual refreshes), training each for 30 Adam steps,
and prints the NLML and train RMSE side by side (the port of
``examples/demo_ski_mixed.py``).  On the CPU the "default" grade rounds the
matvec's operands to bf16 too, so the two runs differ there as well, by the
refined CG's tolerance.

Run: ``python -m gp_grief_tpu_torch.examples.demo_ski_mixed [--n 20000] [--mbar 40] [--device cpu]``
(on the card float32, ``--device cpu`` float64).
"""

from __future__ import annotations

import sys

import numpy as np

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.examples import _common as c


def run(n: int = 20000, mbar: int = 40, *, device: str = "cuda", recipe=None) -> dict:
    cpu = c.recipe_of(device, recipe) == "cpu"
    before, t_all = c.start(device)
    dtype = np.float64 if cpu else np.float32
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(n, 2)).astype(dtype)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    y = (f + 0.1 * rng.standard_normal(n)).astype(dtype)

    out = {}
    for prec in ("exact", "mixed"):
        t0 = c.clock(device)
        model = gpt.GPSKIRegression(x, y, [gpt.make_kernel("rbf", lengthscale=0.7) for _ in range(2)], mbar=mbar,
                                    noise_var=0.1, cg_precision=prec, num_probes=8, cg_tol=1e-6,
                                    dtype=c.torch_dtype(dtype), device=device)
        ll_init = model.log_likelihood()
        res = model.optimize(optimizer="adam", max_iters=30, learning_rate=0.05)
        mean = c.to_np(model.predict(x[:2000], compute_var=False))
        out[prec] = {"ll": model.log_likelihood(), "rmse": float(np.sqrt(np.mean((mean - f[:2000]) ** 2))),
                     "s": c.clock(device) - t0, "ll_init": ll_init, "train_s": res.wall_time,
                     "cg_iterations": int(model.cg_info.iterations), "mean_finite": bool(np.isfinite(mean).all())}
    out.update(wall_s=c.clock(device) - t_all, launches=c.since(before))
    return out


def lines(v: dict) -> list:
    # The script prints ``model.log_likelihood()`` under the label "NLML".
    return [f"cg_precision={prec:5s}  NLML {v[prec]['ll']:12.2f}  "
            f"train-RMSE {v[prec]['rmse']:.4f}  wall {v[prec]['s']:.1f}s" for prec in ("exact", "mixed")]


def main(argv=None) -> int:
    ap = c.parser(__doc__)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--mbar", type=int, default=40)
    args = ap.parse_args(argv)
    print("\n".join(lines(run(n=args.n, mbar=args.mbar, device=args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
