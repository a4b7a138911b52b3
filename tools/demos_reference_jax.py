#!/usr/bin/env python3
"""The JAX demos of ``examples/``, unrounded (``chip_smoke.JAX_DEMOS``).

Usage, from the repository root (CPU, float64 enabled):
    JAX_PLATFORMS=cpu python tools/demos_reference_jax.py [names]

One function per script of ``examples/``, named as the script, holding the
script's own statements (its CPU branch: the same calls, the same NumPy
draws in the same order) with its size arguments as parameters, and
returning every value the script prints, unrounded, with the lines it
prints (``lines``).  ``tests/test_torch_demos_*.py`` run each script's own
``main()`` beside its function and check that the printed lines are these
(wall times masked: ``masked``).

With no argument the command prints one JSON line per demo at
``chip_smoke.DEMO_CPU_ARGS``'s sizes, inside :func:`patched`: the values
``chip_smoke.JAX_DEMOS`` records.  :func:`patched` sets, in this process
only (nothing in the JAX package changes):

* ``jax.random.rademacher`` returns ``chip_smoke.demo_probe(shape)``, one
  NumPy matrix per shape whatever the key: the JAX package draws its probes
  inside compiled programs, where a patched draw runs once per trace, so the
  port (``chip_smoke.DemoProbes``) is handed the same matrix at every draw
  of that shape; a sharded model's shards all get the block of their width;
* the SKI models' eigen-conventions are the port's
  (``tools/ski_reference_jax.py``: sign-canonical eigenvectors, deflation
  ties ordered by index);
* the SKI models' interpolation transpose takes the exact ELL form instead
  of the one-hot Pallas kernel and the windowed plan (the same sums in
  another order; the Pallas kernel runs in interpret mode off a TPU).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")  # demo_sharded's mesh

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import gp_grief_tpu as gpx  # noqa: E402
import gp_grief_tpu.models.gp_ski as jski  # noqa: E402
import gp_grief_tpu.parallel.ski as jpski  # noqa: E402
from gp_grief_tpu.models.gp_kron import GPKroneckerRegression  # noqa: E402
from tools import ski_reference_jax as ref  # noqa: E402

# A wall time as the scripts print it ("1.2s", "in 0.3 s").
TIME = re.compile(r"\b\d+\.\d ?s\b")


def masked(text: str) -> list:
    """The printed lines, wall times masked and the library's progress lines
    (``[optimize_segmented] ...``) dropped."""
    return [TIME.sub("<t>s", ln) for ln in text.splitlines() if ln and not ln.startswith("[")]


def _draw(key, shape, dtype=jnp.float64):
    return jnp.asarray(cs.demo_probe(tuple(int(s) for s in shape)), dtype=dtype)


@contextlib.contextmanager
def patched():
    """The probes, eigen-conventions and interpolation transpose above."""
    saved = [(jax.random, "rademacher", _draw), (jski, "kron_eigh", ref.kron_eigh_canonical),
             (jski, "top_p_kron_eigs", ref.top_p_kron_eigs_quantized),
             (jpski, "kron_eigh", ref.kron_eigh_canonical),
             (jpski, "top_p_kron_eigs", ref.top_p_kron_eigs_quantized),
             (jski, "build_onehot_plan", lambda *a, **k: None),
             (jski, "build_windowed_plan", lambda *a, **k: None)]
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    for mod, name, new in saved:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, orig in old:
            setattr(mod, name, orig)


# -- the seven scripts' statements -------------------------------------------------


def demo_1d_regression(n: int = 1000) -> dict:
    """examples/demo_1d_regression.py:33-60 (the CPU branch: float64, L-BFGS)."""
    rng = np.random.default_rng(0)
    dtype = np.float64
    x = rng.uniform(0, 4, size=(n, 1)).astype(dtype)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(dtype)
    xs = np.linspace(0, 4, 400)[:, None].astype(dtype)
    f_true = np.sin(2 * xs[:, 0])

    grid = gpx.InducingGrid.build(x, mbar=100)
    grief = gpx.GPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.5)], grid,
        n_eigs=10, noise_var=0.5, dtype=dtype,
    )
    res = grief.optimize(max_iters=100, optimizer="lbfgs")
    gm, gv = grief.predict(xs)
    g_rmse = float(np.sqrt(np.mean((gm - f_true) ** 2)))
    out = {"grief_ll": float(grief.log_likelihood()), "grief_rmse": g_rmse, "grief_iters": int(res.iterations),
           "grief_s": float(res.wall_time)}

    sub = slice(0, min(n, 1000))
    exact = gpx.GPRegression(x[sub], y[sub], gpx.make_kernel("rbf", lengthscale=0.5), noise_var=0.5)
    res = exact.optimize(max_iters=50, optimizer="lbfgs")
    em, ev = exact.predict(xs)
    e_rmse = float(np.sqrt(np.mean((em - f_true) ** 2)))
    out.update(exact_ll=float(exact.log_likelihood()), exact_rmse=e_rmse, exact_iters=int(res.iterations),
               exact_s=float(res.wall_time), mean_gap=float(np.abs(np.asarray(gm) - np.asarray(em)).mean()))
    return out


def lines_1d_regression(v: dict) -> list:
    return [f"GP-GRIEF : ll={v['grief_ll']:10.2f}  rmse={v['grief_rmse']:.4f}  "
            f"({v['grief_iters']} iters, {v['grief_s']:.1f}s)",
            f"exact GP : ll={v['exact_ll']:10.2f}  rmse={v['exact_rmse']:.4f}  "
            f"({v['exact_iters']} iters, {v['exact_s']:.1f}s)",
            f"mean abs predictive-mean gap GRIEF vs exact: {v['mean_gap']:.5f}"]


def demo_grief_highdim(d: int = 100, n: int = 2000, p: int = 200, ard_iters: int = 25) -> dict:
    """examples/demo_grief_highdim.py:38-79 (the CPU branch: float64)."""
    rng = np.random.default_rng(0)
    dtype = np.float64
    x = rng.uniform(0, 1, size=(n, d)).astype(dtype)
    y = (np.sin(4 * x[:, 0]) + 0.7 * np.cos(3 * x[:, 1]) + 0.3 * x[:, 2]
         + 0.05 * rng.standard_normal(n)).astype(dtype)

    grid = gpx.InducingGrid.build(x, mbar=10)
    out = {"d": d, "grid_pts": int(grid.grid_shape[0]), "log10_virtual": float(grid.log10_num_virtual)}
    kerns = [gpx.make_kernel("rbf", lengthscale=1.5) for _ in range(d)]
    model = gpx.GPGriefModel(
        x, y, kerns, grid, n_eigs=p, noise_var=0.1, dtype=dtype,
        opt_kernel_params=True, dim_noise_var=1e-8,
    )
    out["ll_init"] = float(model.log_likelihood())
    res = model.optimize(optimizer="adam", max_iters=ard_iters, learning_rate=0.05)
    out.update(ll_ard=float(model.log_likelihood()), ard_iters=int(res.iterations), ard_s=float(res.wall_time))
    model.opt_kernel_params = False
    model.refresh_basis()
    res = model.optimize(optimizer="adam", max_iters=150, learning_rate=0.05)
    out.update(ll_polish=float(model.log_likelihood()), polish_iters=int(res.iterations),
               polish_s=float(res.wall_time))
    ls = sorted(
        (float(jnp.exp(k.log_lengthscale)), i) for i, k in enumerate(model.params["kernels"])
    )
    out["relevant"] = [i for _, i in ls[:5]]
    out["lengthscales"] = [float(jnp.exp(k.log_lengthscale)) for k in model.params["kernels"]]

    xs = rng.uniform(0, 1, size=(500, d)).astype(dtype)
    f_true = np.sin(4 * xs[:, 0]) + 0.7 * np.cos(3 * xs[:, 1]) + 0.3 * xs[:, 2]
    mean = model.predict(xs, compute_var=False)
    out["rmse"] = float(np.sqrt(np.mean((np.asarray(mean) - f_true) ** 2)))
    return out


def lines_grief_highdim(v: dict) -> list:
    return [f"grid: {v['d']} dims × {v['grid_pts']} pts = 10^{v['log10_virtual']:.0f} virtual inducing points",
            f"initial ll: {v['ll_init']:.2f}",
            f"after ARD phase ll: {v['ll_ard']:.2f} ({v['ard_iters']} iters, {v['ard_s']:.1f}s)",
            f"after reweight polish ll: {v['ll_polish']:.2f} ({v['polish_iters']} iters, {v['polish_s']:.1f}s)",
            f"most relevant dims (smallest lengthscales): {v['relevant']}",
            f"test RMSE vs truth: {v['rmse']:.4f}"]


def demo_kron_grid() -> dict:
    """examples/demo_kron_grid.py:28-82 (no size argument: the 40³ lattice;
    the precision is JAX's, float64 under x64)."""
    rng = np.random.default_rng(0)

    xg = [np.linspace(0, 1, 40)[:, None] for _ in range(3)]
    g0, g1, g2 = np.meshgrid(*[g[:, 0] for g in xg], indexing="ij")
    f = np.sin(4 * g0) * np.cos(3 * g1) + 0.5 * g2
    y = (f + 0.05 * rng.standard_normal(f.shape)).reshape(-1)

    model = GPKroneckerRegression(
        xg, y, [gpx.make_kernel("matern52", lengthscale=0.3) for _ in range(3)],
        noise_var=0.1,
    )
    out = {"m": int(model.m), "nlml": float(model.log_likelihood())}
    model.optimize(optimizer="adam", max_iters=60, learning_rate=0.1)
    out["nlml_trained"] = float(model.log_likelihood())
    out["params"] = [float(v) for v in np.asarray(jax.flatten_util.ravel_pytree(model.params)[0])]

    xs = rng.uniform(0.05, 0.95, size=(500, 3))
    fs = np.sin(4 * xs[:, 0]) * np.cos(3 * xs[:, 1]) + 0.5 * xs[:, 2]
    mean, var = model.predict(xs)
    out.update(rmse=float(np.sqrt(np.mean((np.asarray(mean) - fs) ** 2))), var_min=float(var.min()),
               var_max=float(var.max()))

    xg2 = [np.linspace(0, 1, 12)[:, None], rng.uniform(0, 1, size=(30, 2))]
    m2 = 12 * 30
    y2 = rng.standard_normal(m2)
    grouped = GPKroneckerRegression(
        xg2, y2,
        [gpx.make_kernel("rbf", lengthscale=0.4),
         gpx.make_kernel("rbf", lengthscale=0.5, input_dim=2)],
        noise_var=0.3,
    )
    out.update(grouped_dims=[list(c) for c in grouped.dims], grouped_nlml=float(grouped.log_likelihood()))
    mg, vg = grouped.predict(rng.uniform(0, 1, size=(5, 3)))
    out["grouped_mean"] = [float(v) for v in np.asarray(mg)[:3]]

    out["mesh"] = None
    if len(jax.devices()) >= 2:
        from gp_grief_tpu.parallel import make_mesh

        k = 2 if len(jax.devices()) % 2 == 0 else 1
        if k > 1:
            mesh = make_mesh((len(jax.devices()) // k, k), ("data", "model"))
            par = GPKroneckerRegression(
                xg, y,
                [gpx.make_kernel("matern52", lengthscale=0.3) for _ in range(3)],
                noise_var=0.1, solver="cg", mesh=mesh,
            )
            out.update(mesh_nlml=float(par.log_likelihood()),
                       mesh=dict(zip(mesh.axis_names, (int(s) for s in mesh.devices.shape))))
    return out


def lines_kron_grid(v: dict) -> list:
    out = [f"lattice m = {v['m']}  NLML = {v['nlml']}", f"after training NLML = {v['nlml_trained']}",
           f"off-grid predict rmse = {v['rmse']:.4f}  (noise floor 0.05), "
           f"var in [{v['var_min']:.2e}, {v['var_max']:.2e}]",
           f"grouped dims: {tuple(tuple(c) for c in v['grouped_dims'])}  NLML = {v['grouped_nlml']}",
           f"grouped predict mean[:3] = {np.round(np.asarray(v['grouped_mean']), 3)}"]
    if v["mesh"] is not None:
        out.append(f"model-parallel CG NLML = {v['mesh_nlml']}  (mesh: {v['mesh']} )")
    return out


def demo_sharded(dtype=np.float32) -> dict:
    """examples/demo_sharded.py:39-70 on every device of this process (8
    virtual CPU devices); ``dtype`` the script's float32 unless given."""
    out = {"devices": str(jax.devices())}
    rng = np.random.default_rng(0)
    n, d = 4000, 3
    x = rng.uniform(0, 1, size=(n, d)).astype(dtype)
    y = (np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2]
         + 0.05 * rng.standard_normal(n)).astype(dtype)

    from gp_grief_tpu.parallel import ShardedGPGriefModel

    model = ShardedGPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.4) for _ in range(d)],
        n_eigs=64, mbar=12, noise_var=0.2, dtype=dtype,
    )
    out["ll_init"] = float(model.log_likelihood())
    res = model.optimize(optimizer="adam", max_iters=100, learning_rate=0.05)
    out.update(ll=float(model.log_likelihood()), iters=int(res.iterations), train_s=float(res.wall_time))

    xs = rng.uniform(0.1, 0.9, size=(400, d)).astype(dtype)
    truth = np.sin(4 * xs[:, 0]) * np.cos(3 * xs[:, 1]) + 0.5 * xs[:, 2]
    mean = model.predict(xs, compute_var=False)
    out["rmse"] = float(np.sqrt(np.mean((np.asarray(mean) - truth) ** 2)))

    from gp_grief_tpu.parallel import ShardedGPSKIRegression

    ski = ShardedGPSKIRegression(
        x[:, :2], y, gpx.make_kernel("rbf", lengthscale=0.4), mbar=10,
        noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=300,
        cg_tol=1e-8, precond_rank=64,
    )
    out["ski_ll"] = float(ski.log_likelihood())
    mean_s, var_s = ski.predict(xs[:, :2][:100])
    out.update(ski_mean=[float(v) for v in np.asarray(mean_s)], ski_var=[float(v) for v in np.asarray(var_s)])
    return out


def lines_sharded(v: dict) -> list:
    return [f"devices: {v['devices']}", f"initial ll: {v['ll_init']:.2f}",
            f"optimized ll: {v['ll']:.2f} ({v['iters']} iters, {v['train_s']:.1f}s)",
            f"test RMSE: {v['rmse']:.4f}", f"sharded SKI ll: {v['ski_ll']:.2f}",
            f"sharded SKI predict: mean[0]={v['ski_mean'][0]:.3f} var range "
            f"[{min(v['ski_var']):.3e}, {max(v['ski_var']):.3e}]"]


def demo_ski_mixed(n: int = 20000, mbar: int = 40) -> dict:
    """examples/demo_ski_mixed.py:41-60 (the CPU branch: float64)."""
    dtype = "float64"
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(n, 2)).astype(dtype)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    y = (f + 0.1 * rng.standard_normal(n)).astype(dtype)

    out = {}
    for prec in ("exact", "mixed"):
        t0 = time.perf_counter()
        model = gpx.GPSKIRegression(
            x, y, [gpx.make_kernel("rbf", lengthscale=0.7) for _ in range(2)],
            mbar=mbar, noise_var=0.1, cg_precision=prec,
            num_probes=8, cg_tol=1e-6,
        )
        model.optimize(optimizer="adam", max_iters=30, learning_rate=0.05)
        mean = model.predict(x[:2000], compute_var=False)
        rmse = float(np.sqrt(np.mean((np.asarray(mean) - f[:2000]) ** 2)))
        out[prec] = {"ll": float(model.log_likelihood()), "rmse": rmse, "s": time.perf_counter() - t0}
    return out


def lines_ski_mixed(v: dict) -> list:
    return [f"cg_precision={prec:5s}  NLML {v[prec]['ll']:12.2f}  "
            f"train-RMSE {v[prec]['rmse']:.4f}  wall {v[prec]['s']:.1f}s" for prec in ("exact", "mixed")]


def demo_exact_matrixfree(n: int = 5000, dtype=np.float32) -> dict:
    """examples/demo_exact_matrixfree.py:40-63; ``dtype`` the script's
    float32 unless given."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 3, size=(n, 2)).astype(dtype)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    y = (f + 0.05 * rng.standard_normal(n)).astype(dtype)

    model = gpx.GPRegression(
        x, y, gpx.make_kernel("rbf", lengthscale=0.8), noise_var=0.05,
        solver="iterative", num_probes=8, lanczos_iters=24,
        cg_tol=1e-5, cg_iters=100, precond_rank=128,
        matvec_chunk=max(128, (1 << 28) // n),
    )
    t0 = time.perf_counter()
    ll = model.log_likelihood_iterative_segmented(
        cg_segment_iters=8, probe_chunk=2, slq_iter_segment=6,
    )
    out = {"n": n, "ll": float(ll), "nlml_s": time.perf_counter() - t0}

    xs = rng.uniform(0.3, 2.7, size=(200, 2)).astype(dtype)
    t0 = time.perf_counter()
    mean = model.predict(xs, compute_var=False, chunk=64)
    out.update(rmse=float(np.sqrt(np.mean((np.asarray(mean) - np.sin(2 * xs[:, 0]) * np.cos(xs[:, 1])) ** 2))),
               predict_s=time.perf_counter() - t0)
    return out


def lines_exact_matrixfree(v: dict) -> list:
    return [f"matrix-free NLML @ n={v['n']}: {v['ll']:.1f}  ({v['nlml_s']:.1f}s; "
            "every device program watchdog-bounded)",
            f"predict 200 pts: rmse vs truth {v['rmse']:.4f}  ({v['predict_s']:.1f}s)"]


def f_true(x):
    return (
        np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
        + 0.5 * x[:, 2] * x[:, 3]
    )


def demo_ski_1m(n: int = 1_000_000, ms: int = 32, steps: int = 20, n_test: int = 2000, dtype=np.float32) -> dict:
    """examples/demo_ski_1m.py:58-96 (no compilation cache: this process's
    own setting); ``dtype`` the script's float32 unless given."""
    d = 4
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(n, d)).astype(dtype)
    y = (f_true(x) + 0.05 * rng.standard_normal(n)).astype(dtype)
    xg = [np.linspace(-0.05, 1.05, ms, dtype=dtype)[:, None]] * d

    t0 = time.time()
    model = gpx.GPSKIRegression(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.3) for _ in range(d)],
        xg, noise_var=0.05, solver="lattice", train_mixed16=True,
        num_probes=8, lanczos_iters=30, cg_iters=300, cg_tol=1e-6,
    )
    out = {"n": n, "ms": ms, "d": d, "build_s": time.time() - t0}

    t0 = time.time()
    res = model.optimize_segmented(
        max_iters=steps, learning_rate=0.05, num_probes=8, verbose=True
    )
    out.update(steps=steps, train_s=time.time() - t0, losses=[float(v) for v in np.asarray(res.losses)])

    t0 = time.time()
    ll = model.log_likelihood_segmented()
    out.update(nlml=-float(ll), nlml_s=time.time() - t0)

    xs = rng.uniform(0.05, 0.95, size=(n_test, d)).astype(dtype)
    t0 = time.time()
    mean, var = model.predict(xs)
    rmse = float(np.sqrt(np.mean((np.asarray(mean) - f_true(xs)) ** 2)))
    cal = float(np.mean(np.abs(np.asarray(mean) - f_true(xs)) <= 2 * np.sqrt(np.asarray(var) + np.exp(
        float(model.params["log_noise"])))))
    out.update(n_test=n_test, predict_s=time.time() - t0, rmse=rmse, var_min=float(var.min()),
               var_max=float(var.max()), coverage=cal, noise_var=float(np.exp(float(model.params["log_noise"]))))
    assert rmse < 0.05 and var.min() >= 0 and var.max() > 0
    return out


def lines_ski_1m(v: dict) -> list:
    return [f"build: n={v['n']:,}, lattice {v['ms']}^{v['d']} (M={v['ms']**v['d']:,}) in {v['build_s']:.1f} s",
            f"train: {v['steps']} Adam steps in {v['train_s']:.1f} s "
            f"(surrogate {v['losses'][0]:.0f} -> {v['losses'][-1]:.0f})",
            f"true NLML: {v['nlml']:.1f} in {v['nlml_s']:.1f} s",
            f"predict: {v['n_test']} points in {v['predict_s']:.1f} s — rmse {v['rmse']:.4f}, var range "
            f"[{v['var_min']:.2e}, {v['var_max']:.2e}], 2σ coverage {v['coverage']:.3f}",
            "OK"]


ALL = {"demo_1d_regression": (demo_1d_regression, lines_1d_regression),
       "demo_grief_highdim": (demo_grief_highdim, lines_grief_highdim),
       "demo_kron_grid": (demo_kron_grid, lines_kron_grid),
       "demo_sharded": (demo_sharded, lines_sharded),
       "demo_ski_mixed": (demo_ski_mixed, lines_ski_mixed),
       "demo_exact_matrixfree": (demo_exact_matrixfree, lines_exact_matrixfree),
       "demo_ski_1m": (demo_ski_1m, lines_ski_1m)}


def run(name: str, **sizes) -> dict:
    """``name``'s function at ``sizes`` (default ``chip_smoke.DEMO_CPU_ARGS``'s),
    inside :func:`patched`; float64 where the script fixes float32."""
    fn = ALL[name][0]
    args = dict(cs.DEMO_CPU_ARGS[name], **sizes)
    if "dtype" in args:
        args["dtype"] = np.dtype(args["dtype"]).type
    with patched():
        return fn(**args)


if __name__ == "__main__":
    for name in sys.argv[1:] or list(ALL):
        print(json.dumps({"demo": name, **run(name)}), flush=True)
