"""The matrix-free exact GP at large n.

``GPRegression(solver="iterative")`` with a row-block ``matvec_chunk``
never forms the (n, n) Gram: every CG and SLQ matvec rebuilds (chunk, n)
kernel slabs, the pivoted-Cholesky preconditioner is built from r single
kernel rows, and the NLML (CG segments of 8 iterations, SLQ probe chunks of
2) and the prediction run as host loops (the port of
``examples/demo_exact_matrixfree.py``).  O(n²) per matvec: exact GPs at this
scale are for when the structured models' assumptions do not fit.

Run: ``python -m gp_grief_tpu_torch.examples.demo_exact_matrixfree [--n 100000] [--device cpu]``
(n = 100,000 on the card, 5,000 with ``--device cpu``; float32, as the
script; ``dtype=`` in :func:`run`).
"""

from __future__ import annotations

import sys

import numpy as np

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.examples import _common as c


def run(n=None, *, device: str = "cuda", recipe=None, dtype=np.float32) -> dict:
    cpu = c.recipe_of(device, recipe) == "cpu"
    n = n or (5_000 if cpu else 100_000)
    before, t_all = c.start(device)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 3, size=(n, 2)).astype(dtype)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    y = (f + 0.05 * rng.standard_normal(n)).astype(dtype)

    model = gpt.GPRegression(x, y, gpt.make_kernel("rbf", lengthscale=0.8), noise_var=0.05, solver="iterative",
                             num_probes=8, lanczos_iters=24, cg_tol=1e-5, cg_iters=100, precond_rank=128,
                             matvec_chunk=max(128, (1 << 28) // n), dtype=c.torch_dtype(dtype), device=device)
    t0 = c.clock(device)
    ll = model.log_likelihood_iterative_segmented(cg_segment_iters=8, probe_chunk=2)
    out = {"n": n, "ll": ll, "nlml_s": c.clock(device) - t0, "cg_iterations": model.cg_iterations}

    xs = rng.uniform(0.3, 2.7, size=(200, 2)).astype(dtype)
    t0 = c.clock(device)
    mean = c.to_np(model.predict(xs, compute_var=False, chunk=64))
    out.update(rmse=float(np.sqrt(np.mean((mean - np.sin(2 * xs[:, 0]) * np.cos(xs[:, 1])) ** 2))),
               predict_s=c.clock(device) - t0, mean_finite=bool(np.isfinite(mean).all()),
               wall_s=c.clock(device) - t_all, launches=c.since(before))
    return out


def lines(v: dict) -> list:
    return [f"matrix-free NLML @ n={v['n']}: {v['ll']:.1f}  ({v['nlml_s']:.1f}s)",
            f"predict 200 pts: rmse vs truth {v['rmse']:.4f}  ({v['predict_s']:.1f}s)"]


def main(argv=None) -> int:
    ap = c.parser(__doc__)
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args(argv)
    print("\n".join(lines(run(n=args.n, device=args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
