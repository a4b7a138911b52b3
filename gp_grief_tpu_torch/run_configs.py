"""The BASELINE configurations through the port: one JSON line of metrics each.

The counterpart of ``benchmarks/run_configs.py``: the same five
configurations, data, seeds and recipes, and the same keys in each line.

1. ``sine1d`` — 1-D sine, n = 1000, a 100-point grid, p = 10, and the
   exact-GP parity check (GP-GRIEF with the full basis against
   ``GPRegression`` on grid data).  float64.
2. ``grid3d`` — a 22³ product grid (n = 10,648): Schur and CG NLML of
   ``GPKroneckerRegression``.  float64.
3. ``kin40k`` — kin40k, or the kin40k-shaped synthetic set (n = 40k,
   d = 8): 150 Adam steps on the kernel parameters, 200 reweight steps, test
   rmse and nll.  float32.
4. ``uci2m`` — a large UCI set, or the 2M-point synthetic set (d = 10): 150
   reweight steps, test rmse, and the NLML at the optimum both in closed
   form and by CG + SLQ on the full training operator (1.9M rows on the
   synthetic set).  float32.
5. ``d100`` — d = 100 (10¹⁰⁰ virtual grid points): basis, NLML, 50 Adam
   steps, predict.  float64.

kin40k and uci2m run on the real sets when their files are dropped into
``benchmarks/data/`` or ``$GP_GRIEF_DATA`` (``gp_grief_tpu_torch.data``;
:func:`kin40k_split`, :func:`uci2m_split`), tagged ``kin40k_real`` /
``uci2m_real``, else on the synthetic sets (``kin40k_synth`` /
``uci2m_synth``).  Each config function returns every value it computed,
the tag as ``config``; the line printed holds the reference runner's keys.

Run: ``python -m gp_grief_tpu_torch.run_configs [names] [--device cpu]``
(default: sine1d grid3d d100, on the card).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.data import load_kin40k, load_uci2m, standardize

__all__ = ["ALL", "KEYS", "kin40k_data", "kin40k_model", "kin40k_split", "uci2m_data", "uci2m_model",
           "uci2m_split", "sine1d", "grid3d", "kin40k", "uci2m", "d100"]

# The keys of benchmarks/run_configs.py's line for each configuration.
KEYS = {
    "sine1d": ("rmse", "rmse_exact", "rmse_gap", "mean_gap", "parity_nlml_gap", "parity_mean_gap", "train_s"),
    "grid3d": ("n", "ll_schur", "ll_cg", "ll_rel_gap", "schur_s", "cg_s"),
    "kin40k": ("n", "d", "p", "rmse", "nll", "train_s", "virtual_pts_log10"),
    "uci2m": ("n", "d", "p", "rmse", "basis_s", "train_s", "nlml_closed", "nlml_slq_cg", "slq_cg_nlml_gap",
              "slq_cg_s"),
    "d100": ("virtual_pts_log10", "ll", "ll_opt", "build_s", "pred_finite"),
}

# uci2m's iterative NLML, as benchmarks/run_configs.py:234-237 calls it.
UCI2M_ITERATIVE = dict(num_probes=8, lanczos_iters=48, cg_tol=1e-5, cg_iters=300, precond_rank=300,
                       cg_segment_iters=50, probe_chunk=4)


def _timed(fn, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def kin40k_data():
    """kin40k's synthetic set: 30k training and 10k test points in 8-D, the
    test labels and noise-free targets."""
    rng = np.random.default_rng(0)
    n, d = 40000, 8
    x = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    f = (np.sin(3 * x[:, 0] * x[:, 1]) + x[:, 2] * np.cos(2 * x[:, 3])
         + np.sin(x[:, 4] + 2 * x[:, 5]) * x[:, 6] + 0.5 * x[:, 7] ** 2)
    y = (f + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return x[:30000], y[:30000], x[30000:], y[30000:], f[30000:]


def uci2m_data():
    """uci2m's synthetic set: 1.9M training and 100k test points in 10-D,
    and the test points' noise-free targets."""
    rng = np.random.default_rng(0)
    n, d = 2_000_000, 10
    x = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.4 * x[:, 2] * x[:, 3] + np.tanh(x[:, 4] + x[:, 5])
    y = (f + 0.1 * rng.standard_normal(n)).astype(np.float32)
    n_te = min(100_000, max(1, n // 5))
    return x[:-n_te], y[:-n_te], x[-n_te:], f[-n_te:]


def kin40k_split():
    """kin40k's data as ``(tag, xtr, ytr, xte, yte, fte)``: the real set
    where ``data.load_kin40k`` finds it, standardized with the training
    split's statistics, float32, the test labels as the targets
    (``kin40k_real``); else :func:`kin40k_data` (``kin40k_synth``)."""
    real = load_kin40k(dtype=np.float32)
    if real is None:
        return ("kin40k_synth", *kin40k_data())
    xtr, ytr, xte, yte, _ = standardize(*real)
    xtr, ytr, xte, yte = (np.asarray(a, dtype=np.float32) for a in (xtr, ytr, xte, yte))
    return "kin40k_real", xtr, ytr, xte, yte, yte


def uci2m_split():
    """uci2m's data as ``(tag, xtr, ytr, xte, fte)``: the real set where
    ``data.load_uci2m`` finds it, x and y standardized with the whole set's
    statistics, float32, the last ``min(100k, n // 5)`` rows for test and
    their labels as the targets (``uci2m_real``); else :func:`uci2m_data`
    (``uci2m_synth``)."""
    real = load_uci2m(dtype=np.float32)
    if real is None:
        return ("uci2m_synth", *uci2m_data())
    x, y = real
    xm, xs = x.mean(0), x.std(0) + 1e-12
    ym, ys = y.mean(), y.std() + 1e-12
    x, y = ((x - xm) / xs).astype(np.float32), ((y - ym) / ys).astype(np.float32)
    n_te = min(100_000, max(1, x.shape[0] // 5))
    return "uci2m_real", x[:-n_te], y[:-n_te], x[-n_te:], y[-n_te:]


def sine1d(device="cuda") -> dict:
    """Besides the reference's keys: ``nlml_grief``/``nlml_exact``, the
    trained NLML of the two models."""
    rng = np.random.default_rng(0)
    n = 1000
    x = rng.uniform(0, 4, size=(n, 1))
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    xs = np.linspace(0.1, 3.9, 200)[:, None]
    f = np.sin(2 * xs[:, 0])

    def train_grief():
        grid = gpt.InducingGrid.build(x, mbar=100)
        model = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.5)], grid, n_eigs=10,
                                 noise_var=0.5, device=device)
        model.optimize(max_iters=100)
        return grid, model, model.predict(xs)

    (grid, model, (mean, _)), t_grief = _timed(train_grief, device)
    exact = gpt.GPRegression(x, y, gpt.make_kernel("rbf", lengthscale=0.5), noise_var=0.5, device=device)
    exact.optimize(max_iters=50)
    em, _ = exact.predict(xs)
    mean, em = _np(mean), _np(em)
    rmse = float(np.sqrt(np.mean((mean - f) ** 2)))
    rmse_exact = float(np.sqrt(np.mean((em - f) ** 2)))

    # On-grid training data and the full basis (p = m): the GRIEF kernel
    # equals the exact kernel on the training set and the Nyström extension
    # is exact, so NLML and predictive means agree to float64 precision.
    xg_pts = np.asarray(grid.xg[0])  # (100, 1)
    yg = np.sin(2 * xg_pts[:, 0]) + 0.1 * np.random.default_rng(1).standard_normal(100)
    kern = gpt.make_kernel("rbf", lengthscale=0.5)
    full = gpt.GPGriefModel(xg_pts, yg, [kern], grid, n_eigs=100, noise_var=0.05, dim_noise_var=1e-10,
                            device=device)
    og_exact = gpt.GPRegression(xg_pts, yg, kern, noise_var=0.05, device=device)
    fm = _np(full.predict(xs, compute_var=False))
    om = _np(og_exact.predict(xs, compute_var=False))
    return dict(
        rmse=rmse, rmse_exact=rmse_exact, rmse_gap=abs(rmse - rmse_exact), mean_gap=float(np.abs(mean - em).mean()),
        parity_nlml_gap=float(abs(full.log_likelihood() - og_exact.log_likelihood())),
        parity_mean_gap=float(np.abs(fm - om).max()), train_s=t_grief,
        nlml_grief=-model.log_likelihood(), nlml_exact=-exact.log_likelihood(),
    )


def grid3d(device="cuda") -> dict:
    rng = np.random.default_rng(0)
    gs = [np.linspace(0, 1, 22)[:, None], np.linspace(0, 2, 22)[:, None], np.linspace(-1, 1, 22)[:, None]]
    m = 22**3
    pts = np.stack(np.meshgrid(*[g[:, 0] for g in gs], indexing="ij"), -1).reshape(-1, 3)
    y = np.sin(3 * pts[:, 0]) * np.cos(2 * pts[:, 1]) + 0.3 * pts[:, 2] + 0.05 * rng.standard_normal(m)
    kerns = [gpt.make_kernel("rbf", lengthscale=0.4) for _ in range(3)]

    def ll(**kw):
        return gpt.GPKroneckerRegression(gs, y, kerns, noise_var=0.05, device=device, **kw).log_likelihood()

    ll_schur, t_schur = _timed(lambda: ll(solver="schur"), device)
    ll_cg, t_cg = _timed(lambda: ll(solver="cg", cg_tol=1e-10), device)
    return dict(n=m, ll_schur=ll_schur, ll_cg=ll_cg, ll_rel_gap=abs(ll_schur - ll_cg) / abs(ll_schur),
                schur_s=t_schur, cg_s=t_cg)


def kin40k_model(xtr, ytr, dtype, device):
    """kin40k's model before training: p = 400 on a 16-point grid per
    dimension, the kernel hyperparameters trained (``opt_kernel_params``)."""
    grid = gpt.InducingGrid.build(xtr, mbar=16)
    kerns = [gpt.make_kernel("rbf", lengthscale=0.7) for _ in range(xtr.shape[1])]
    return gpt.GPGriefModel(xtr, ytr, kerns, grid, n_eigs=400, noise_var=0.1, dtype=dtype, device=device,
                            opt_kernel_params=True, dim_noise_var=1e-6)


def kin40k(device="cuda") -> dict:
    tag, xtr, ytr, xte, yte, fte = kin40k_split()

    def train():
        # Phase 1: the kernel hyperparameters, weights and noise (the basis
        # rebuilt inside the objective); phase 2: reweighting at those.
        model = kin40k_model(xtr, ytr, torch.float32, device)
        model.optimize(optimizer="adam", max_iters=150, learning_rate=0.03)
        model.opt_kernel_params = False
        model.refresh_basis()
        model.optimize(optimizer="adam", max_iters=200, learning_rate=0.05)
        return model

    model, t_train = _timed(train, device)
    mean, var = (_np(t) for t in model.predict(xte, include_noise=True))
    rmse = float(np.sqrt(np.mean((mean - fte) ** 2)))
    nll = float(np.mean(0.5 * np.log(2 * np.pi * var) + 0.5 * (yte - mean) ** 2 / var))
    return dict(config=tag, n=xtr.shape[0] + xte.shape[0], d=xtr.shape[1], p=model.n_eigs, rmse=rmse, nll=nll,
                train_s=t_train, virtual_pts_log10=model.grid.log10_num_virtual)


def uci2m_model(xtr, ytr, device):
    """uci2m's model: p = 400 on a 10-point grid per dimension built from
    the first 200k points, float32; the build assembles the chunked
    statistics."""
    grid = gpt.InducingGrid.build(xtr[:200000], mbar=10)
    return gpt.GPGriefModel(xtr, ytr, gpt.make_kernel("rbf", lengthscale=1.0, input_dim=1), grid,
                            n_eigs=400, noise_var=0.2, dtype=torch.float32, device=device)


def uci2m(device="cuda") -> dict:
    """Besides the reference's keys: ``cg_iterations`` of the iterative
    NLML."""
    tag, xtr, ytr, xte, fte = uci2m_split()
    model, t_build = _timed(lambda: uci2m_model(xtr, ytr, device), device)
    _, t_train = _timed(lambda: model.optimize(optimizer="adam", max_iters=150, learning_rate=0.05), device)
    mean = _np(model.predict(xte, compute_var=False))
    rmse = float(np.sqrt(np.mean((mean - fte) ** 2)))
    ll_closed = model.log_likelihood()
    ll_iter, t_iter = _timed(lambda: model.log_likelihood_iterative_segmented(**UCI2M_ITERATIVE), device)
    return dict(config=tag, n=xtr.shape[0] + xte.shape[0], d=xtr.shape[1], p=400, rmse=rmse, basis_s=t_build,
                train_s=t_train, nlml_closed=ll_closed, nlml_slq_cg=ll_iter,
                slq_cg_nlml_gap=abs(ll_iter - ll_closed) / abs(ll_closed), slq_cg_s=t_iter,
                cg_iterations=model.cg_iterations)


def d100(device="cuda") -> dict:
    rng = np.random.default_rng(0)
    n, d, p = 1000, 100, 300
    x = rng.uniform(0, 1, size=(n, d))
    y = np.sin(4 * x[:, 0]) + 0.7 * np.cos(3 * x[:, 1]) + 0.05 * rng.standard_normal(n)

    def build():
        grid = gpt.InducingGrid.build(x, mbar=10)
        model = gpt.GPGriefModel(x, y, gpt.make_kernel("rbf", lengthscale=1.5), grid, n_eigs=p, noise_var=0.1,
                                 device=device)
        return grid, model, model.log_likelihood()

    (grid, model, ll), t_build = _timed(build, device)
    model.optimize(optimizer="adam", max_iters=50, learning_rate=0.05)
    mean, var = (_np(t) for t in model.predict(x[:100]))
    return dict(virtual_pts_log10=grid.log10_num_virtual, ll=ll, ll_opt=model.log_likelihood(), build_s=t_build,
                pred_finite=bool(np.all(np.isfinite(mean)) and np.all(np.isfinite(var))))


ALL = {"sine1d": sine1d, "grid3d": grid3d, "kin40k": kin40k, "uci2m": uci2m, "d100": d100}


def line(name: str, out: dict) -> str:
    """The reference runner's JSON line: the run's tag (``out["config"]``,
    else ``name``), its keys, floats rounded to 6 decimals."""
    kv = {k: out[k] for k in KEYS[name]}
    return json.dumps({"config": out.get("config", name),
                       **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in kv.items()}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"of {', '.join(ALL)} (default: sine1d grid3d d100)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(ALL))
    if unknown:
        ap.error(f"unknown configurations {unknown}")
    for name in args.names or ["sine1d", "grid3d", "d100"]:
        print(line(name, ALL[name](device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
