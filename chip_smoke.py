#!/usr/bin/env python3
"""Drive the PyTorch port's GP-GRIEF main path once on one NVIDIA GPU.

Usage, from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero without printing the final line:

1. device  — a CUDA device must exist; prints its name and power limit.
2. build   — compiles the port's CUDA kernels from gp_grief_tpu_torch/csrc/.
3. kernel  — K1 (the fused Φ assembly) against its plain PyTorch version on
             the card, float32 and float64, at the main path's shapes and one
             ragged shape; CUDA-event times of both.
4. kin40k  — the kin40k_synth config (benchmarks/run_configs.py:kin40k):
             first its float64 NLML and gradient at the initial parameters
             against the JAX package's; then, twice, end to end through
             ``GPGriefModel``: 150 Adam steps training the kernel
             hyperparameters, refresh_basis, 200 reweight steps, predict.
             The two runs must agree bit for bit, and the predictions are
             held to a recorded JAX run of the same config.
5. uci2m   — the uci2m_synth config in closed form at n = 2M
             (benchmarks/run_configs.py:uci2m): chunked statistics, 150
             reweight steps, predict on 100k points.
6. kron    — K2 (kron_matvec_slab) and K3 (kron_matvec_fused) against their
             plain version on the card, both grades, at the grid
             configurations' lattices, one d=5 lattice and one ragged d=2
             lattice; CUDA-event times of the kernel, the plain version and
             the port's cyclic torch.matmul chain, beside the bound.
7. grid    — the two grid configurations (GRID_CONFIGS) end to end through
             ``GPKroneckerRegression``: float64 schur NLML against a recorded
             float64 JAX run, float32 CG NLML against float32 schur, the
             kernel launches during the CG NLML, and predict (mean on 10,000
             points, variance on 512).

Then the ``nvidia-smi`` name/power-limit line, one ``{"kernels": [...]}``
line (K1 launches from phases 4-5, K2/K3 launches from phase 7) and, last,
``{"ok": true, "device": {...}}``.  This script imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Fresh JAX run of the same kin40k_synth config, float32 on CPU, jax 0.9.0, at
# commit abf10e0:  JAX_PLATFORMS=cpu python benchmarks/run_configs.py kin40k
JAX_KIN40K = {"rmse": 0.07063515484333038, "nll": -1.0289068222045898}
# Tolerances against it: both runs are float32, but 350 Adam steps through
# eigh, top-p selection and Cholesky drift apart between two frameworks and
# devices (different reduction orders), so the held quantities are the test
# metrics, not the trajectory.  Runs perturbed at rounding level land within
# rmse 0.0700-0.0711 and nll -1.035 to -1.024 in both packages, except when
# the last kernel-parameter step reorders the top-p selection: phase 2 then
# starts with log_w misaligned and ends near rmse 0.171 (the recipe's own
# second mode, in both packages).  The port's training is bitwise
# reproducible on one card, so this check gives the same answer every run.
KIN40K_RMSE_RTOL = 0.05
KIN40K_NLL_ATOL = 0.05
# The same model in float64 at its initial parameters, before any step: NLML
# and gradient from jax.value_and_grad(model._loss)(model.params) on CPU, jax
# 0.9.0, commit abf10e0.  grad_head is the kernel and noise components in the
# flat-vector order (kernels.0.log_lengthscale, kernels.0.log_variance, ...,
# log_noise); the 400 log_w components are held by their norm and sum, which
# do not depend on how ties in the selection are ordered.
JAX_KIN40K_INIT = {
    "nlml": 257.7680049038281,
    "grad_head": [
        1210.0592484022254, 46.992317048675815, 1301.349683438953, 46.992318457887144,
        -1111.3942999130466, 46.99231618045032, -482.91361636995777, 46.9923141437599,
        -892.8599330657532, 46.99232367285239, -336.06818496992014, 46.992316455286264,
        -2288.738731821838, 46.99231925116338, -1179.8368572274499, 46.99232164304309,
        8874.024305384048,
    ],
    "grad_log_w_norm": 52.47257871399364,
    "grad_log_w_sum": 46.992308534627256,
}
# float64 on both sides; eigh, the 30000-row reductions and Cholesky round in
# different orders.  The NLML is a sum of terms near 1e5 that cancel to ~258,
# so it agrees to ~2e-11 relative (the port on CPU), the gradient to ~1e-12.
KIN40K_INIT_RTOL = 1e-9
# uci2m_synth labels carry noise of sd 0.1; the JAX run recorded rmse 0.1017.
UCI2M_RMSE_MAX = 0.12

# K1 error, per element, relative to Π_d Σ_k |B_dk S_kj| (the scale of the
# rounding error of a product of d m-deep dots): both sides round each of
# ~d + m terms once, so float32 stays near 24·6e-8 ≈ 1.4e-6 at m = 16;
# float64 near 24·1.1e-16.
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}

# H100 SXM peaks (NVIDIA's data sheet, dense): memory rate, and the
# operation rate of each grade: FP32 FMA outside the tensor cores, bf16.
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"highest": 67e12, "default": 989e12}

# (name, d, n, m, p): the shapes the main path hands K1.
KERNEL_SHAPES = [
    ("kin40k_stats", 8, 30000, 16, 400),
    ("kin40k_predict", 8, 10000, 16, 400),
    ("uci2m_stats_chunk", 10, 131072, 10, 400),
    ("ragged", 5, 4099, 37, 211),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phi_operands(d, n, m, p, dtype, device, seed=0):
    """K1's operands as the main path builds them: RBF cross-covariances to
    an m-point grid per dimension, and the scaled top-p eigenvector
    selections of the grid Grams."""
    import torch
    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch.kernels.grief import _phi_fused_operands, build_basis
    from gp_grief_tpu_torch.kernels.grid import cross_cov_grid

    x = np.random.default_rng(seed).uniform(-1, 1, size=(n, d))
    grid = gpt.InducingGrid.build(x, mbar=m)
    xg = [torch.as_tensor(g, dtype=dtype, device=device) for g in grid.xg]
    kerns = [gpt.make_kernel("rbf", lengthscale=0.7, dtype=dtype, device=device) for _ in range(d)]
    with torch.no_grad():
        basis = build_basis(kerns, xg, p, dim_noise_var=1e-6)
        Kx = cross_cov_grid(kerns, torch.as_tensor(x, dtype=dtype, device=device), xg)
        return _phi_fused_operands(basis, Kx)


def phase_kernel(card: str) -> dict:
    import torch
    from gp_grief_tpu_torch.ops.cuda import phi_fused, phi_fused_ref

    summary = {"max_abs_err": 0.0}
    for name, d, n, m, p in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).replace("torch.", "")
            with torch.no_grad():
                B, S = phi_operands(d, n, m, p, dtype, "cuda")
                got = phi_fused(B, S)
                torch.cuda.synchronize()
                ref = phi_fused_ref(B, S)
                scale = phi_fused_ref(B.abs(), S.abs()).clamp_min(torch.finfo(dtype).tiny)
                diff = (got - ref).abs()
                rel = float((diff / scale).max())
                abs_err = float(diff.max())
                check(tuple(got.shape) == (n, p) and bool(torch.isfinite(got).all()),
                      f"K1 {name} {tag}: bad output")
                ms = cuda_ms(lambda: phi_fused(B, S))
                plain_ms = cuda_ms(lambda: phi_fused_ref(B, S))
            emit({"phase": "kernel", "kernel": "phi_fused", "shape": name, "d": d, "n": n, "m": m,
                  "p": p, "dtype": tag, "max_rel_err": rel, "max_abs_err": abs_err,
                  "tol": KERNEL_TOL[tag], "tol_reason": "per element, relative to prod_d sum_k |B S|",
                  "ms": ms, "plain_ms": plain_ms, "card": card})
            check(rel <= KERNEL_TOL[tag], f"K1 {name} {tag}: rel err {rel:.3e} > {KERNEL_TOL[tag]}")
            if tag == "float32":
                summary["max_abs_err"] = max(summary["max_abs_err"], abs_err)
                if name == "kin40k_stats":
                    # 2·n·p·d·m FP32 operations against B, S read once and Φ written once.
                    t_ops = 2.0 * n * p * d * m / H100_FLOPS["highest"]
                    t_bytes = 4.0 * (d * n * m + d * m * p + n * p) / H100_BYTES_PER_S
                    summary.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                                   bound_by="operations" if t_ops >= t_bytes else "bytes")
            del B, S, got, ref, scale, diff
            torch.cuda.empty_cache()
    return summary


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kin40k_data():
    """benchmarks/run_configs.py:kin40k, synthetic branch: 30k train, 10k test."""
    rng = np.random.default_rng(0)
    n, d = 40000, 8
    x = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    f = (np.sin(3 * x[:, 0] * x[:, 1]) + x[:, 2] * np.cos(2 * x[:, 3])
         + np.sin(x[:, 4] + 2 * x[:, 5]) * x[:, 6] + 0.5 * x[:, 7] ** 2)
    y = (f + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return x[:30000], y[:30000], x[30000:], y[30000:], f[30000:]


def kin40k_model(xtr, ytr, dtype):
    import torch
    import gp_grief_tpu_torch as gpt

    grid = gpt.InducingGrid.build(xtr, mbar=16)
    kerns = [gpt.make_kernel("rbf", lengthscale=0.7) for _ in range(xtr.shape[1])]
    return gpt.GPGriefModel(
        xtr, ytr, kerns, grid, n_eigs=400, noise_var=0.1, dtype=dtype,
        device="cuda", opt_kernel_params=True, dim_noise_var=1e-6,
    )


def phase_kin40k_init(card: str, data) -> None:
    """NLML and its gradient through eigh, top-p and Φ at the initial
    parameters, float64 on the card, against the JAX package's."""
    import torch

    model = kin40k_model(data[0], data[1], torch.float64)
    nlml = -model.log_likelihood()
    named = dict(model.named_parameters())
    order = [f"kernels.{i}.{leaf}" for i in range(len(model.kernels))
             for leaf in ("log_lengthscale", "log_variance")] + ["log_noise", "log_w"]
    check(sorted(order) == sorted(named), f"unexpected parameters {sorted(named)}")
    # _loss is the NLML that optimize() minimizes.
    grads = torch.autograd.grad(model._loss(), [named[k] for k in order])
    flat = torch.cat([g.reshape(-1) for g in grads]).cpu().numpy()
    p = model.log_w.numel()
    head, gw = flat[:-p], flat[-p:]
    ref = JAX_KIN40K_INIT
    ref_head = np.asarray(ref["grad_head"])
    errs = {
        "nlml": abs(nlml - ref["nlml"]) / abs(ref["nlml"]),
        "grad_head": float(np.abs(head - ref_head).max() / np.abs(ref_head).max()),
        "grad_log_w_norm": abs(float(np.linalg.norm(gw)) - ref["grad_log_w_norm"]) / ref["grad_log_w_norm"],
        "grad_log_w_sum": abs(float(gw.sum()) - ref["grad_log_w_sum"]) / ref["grad_log_w_norm"],
    }
    emit({"phase": "kin40k_init", "dtype": "float64", "nlml": nlml, "jax_nlml": ref["nlml"],
          "rel_err": errs, "tol": KIN40K_INIT_RTOL, "card": card})
    for what, err in errs.items():
        check(err <= KIN40K_INIT_RTOL, f"kin40k init {what}: rel err {err:.3e} vs JAX")


def kin40k_recipe(data) -> dict:
    """Both training phases of benchmarks/run_configs.py:kin40k and predict."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import phi_fused

    xtr, ytr, xte, _, _ = data

    def build_and_train_kernels():
        model = kin40k_model(xtr, ytr, torch.float32)
        return model, model.optimize(optimizer="adam", max_iters=150, learning_rate=0.03)

    (model, res1), t1 = timed(build_and_train_kernels)
    check(res1.iterations == 150, f"kin40k phase 1 stopped at step {res1.iterations}")
    model.opt_kernel_params = False
    before = phi_fused.launches
    _, t_refresh = timed(model.refresh_basis)
    check(phi_fused.launches > before, "kin40k refresh_basis did not launch K1")
    res2, t2 = timed(lambda: model.optimize(optimizer="adam", max_iters=200, learning_rate=0.05))
    check(res2.iterations == 200, f"kin40k phase 2 stopped at step {res2.iterations}")
    before = phi_fused.launches
    (mean, var), t_pred = timed(lambda: model.predict(xte, include_noise=True))
    check(phi_fused.launches > before, "kin40k predict did not launch K1")
    return {"mean": mean.cpu().numpy(), "var": var.cpu().numpy(), "res1": res1, "res2": res2,
            "s": {"phase1_150_steps": t1, "refresh_basis": t_refresh, "phase2_200_steps": t2,
                  "predict_10k": t_pred}}


def phase_kin40k(card: str) -> None:
    data = kin40k_data()
    _, _, _, yte, fte = data
    phase_kin40k_init(card, data)
    # The recipe twice: the second run must repeat the first bit for bit.
    runs = [kin40k_recipe(data) for _ in range(2)]
    mean, var = runs[0]["mean"], runs[0]["var"]
    check(mean.shape == (10000,) and var.shape == (10000,), "kin40k predict: bad shapes")
    check(bool(np.isfinite(mean).all() and np.isfinite(var).all() and (var > 0).all()),
          "kin40k predict: non-finite or non-positive output")
    repeats = bool(np.array_equal(mean, runs[1]["mean"]) and np.array_equal(var, runs[1]["var"]))
    rmse = float(np.sqrt(np.mean((mean - fte) ** 2)))
    nll = float(np.mean(0.5 * np.log(2 * np.pi * var) + 0.5 * (yte - mean) ** 2 / var))
    res1, res2 = runs[0]["res1"], runs[0]["res2"]
    emit({"phase": "kin40k", "n_train": 30000, "d": 8, "p": 400, "rmse": rmse, "nll": nll,
          "jax_rmse": JAX_KIN40K["rmse"], "jax_nll": JAX_KIN40K["nll"], "second_run_identical": repeats,
          "nlml_phase1": [float(res1.losses[0]), float(res1.losses[-1])],
          "nlml_phase2": [float(res2.losses[0]), float(res2.losses[-1])],
          "s_first_run": runs[0]["s"], "s_second_run": runs[1]["s"], "card": card})
    check(repeats, "kin40k: a second run of the recipe gave different predictions")
    check(abs(rmse - JAX_KIN40K["rmse"]) <= KIN40K_RMSE_RTOL * JAX_KIN40K["rmse"],
          f"kin40k rmse {rmse} vs JAX {JAX_KIN40K['rmse']}")
    check(abs(nll - JAX_KIN40K["nll"]) <= KIN40K_NLL_ATOL, f"kin40k nll {nll} vs JAX {JAX_KIN40K['nll']}")


def phase_uci2m(card: str) -> None:
    import torch
    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch.ops.cuda import phi_fused

    rng = np.random.default_rng(0)
    n, d = 2_000_000, 10
    x = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.4 * x[:, 2] * x[:, 3] + np.tanh(x[:, 4] + x[:, 5])
    y = (f + 0.1 * rng.standard_normal(n)).astype(np.float32)
    n_te = min(100_000, max(1, n // 5))
    xte, fte = x[-n_te:], f[-n_te:]
    xtr, ytr = x[:-n_te], y[:-n_te]

    before = phi_fused.launches

    def build():
        grid = gpt.InducingGrid.build(xtr[:200000], mbar=10)
        return gpt.GPGriefModel(
            xtr, ytr, gpt.make_kernel("rbf", lengthscale=1.0, input_dim=1), grid,
            n_eigs=400, noise_var=0.2, dtype=torch.float32, device="cuda",
        )

    model, t_build = timed(build)
    chunks = -(-xtr.shape[0] // model.stats_chunk)
    check(phi_fused.launches - before >= chunks, f"uci2m stats launched K1 fewer than {chunks} times")
    res, t_train = timed(lambda: model.optimize(optimizer="adam", max_iters=150, learning_rate=0.05))
    check(res.iterations == 150, f"uci2m training stopped at step {res.iterations}")
    mean, t_pred = timed(lambda: model.predict(xte, compute_var=False))
    mean = mean.cpu().numpy()
    check(mean.shape == (n_te,) and bool(np.isfinite(mean).all()), "uci2m predict: bad output")
    rmse = float(np.sqrt(np.mean((mean - fte) ** 2)))
    emit({"phase": "uci2m", "n_train": int(xtr.shape[0]), "d": d, "p": 400, "stats_chunks": chunks,
          "k1_launches": phi_fused.launches - before, "rmse": rmse,
          "nlml": [float(res.losses[0]), float(res.losses[-1])],
          "s_build_and_stats": t_build, "s_train_150_steps": t_train, "s_predict_100k": t_pred,
          "card": card})
    check(rmse <= UCI2M_RMSE_MAX, f"uci2m rmse {rmse} > {UCI2M_RMSE_MAX}")


# ---------------------------------------------------------------------------
# Grid configurations (GPKroneckerRegression) and kernels K2/K3.
# ---------------------------------------------------------------------------

# Both use float32 on the card.  Lengthscales and noise are set so that CG at
# cg_tol = 1e-6 converges inside cg_iters (PERF.md §4 gives the choice).
GRID_CONFIGS = {
    # d = 5, 32 sorted uniform points on [0, 3] per dimension, y ~ N(0, 1)
    # (the data of benchmarks/exp_r4_mixed16_e2e.py, M = 33,554,432).  The
    # mixed refinement's inner matvec is kron_matvec_fast(..., "default"),
    # slab-applicable: K2.  Its exact residual refresh is the matmul chain.
    "grid32x5_mixed": dict(
        sizes=(32,) * 5, lengthscales=(0.05,) * 5, noise_var=10.0,
        model=dict(solver="cg", cg_precision="mixed", precond_rank=0, cg_tol=1e-6, cg_iters=250),
        kernel="kron_matvec_slab",
    ),
    # 8 frames of a 512 x 512 field (M = 2,097,152): time points 0..7, pixel
    # centres on [0, 1].  Every CG matvec and both deflation matvecs are
    # "highest" on square factors with a 512-wide factor and M >= 2^21: K3
    # (plan: mid group (0, 0), tail (512, 512)).
    "grid8x512x512_exact": dict(
        sizes=(8, 512, 512), lengthscales=(2.0, 0.05, 0.05), noise_var=10.0,
        model=dict(solver="cg", cg_precision="exact", precond_rank=512, cg_tol=1e-6, cg_iters=250),
        kernel="kron_matvec_fused",
    ),
}

# float64 schur NLML of each configuration on the same (float32) data cast to
# float64, from the JAX package on the CPU (jax 0.9.0):
#     JAX_PLATFORMS=cpu python tools/grid_reference_jax.py
JAX_GRID_NLML_F64 = {
    "grid32x5_mixed": 72105230.56050768,
    "grid8x512x512_exact": 4449636.9309229255,
}
# float64 on both sides: eigh of the factors and the M-term sums round in
# different orders; the closed form agrees to ~1e-12 (tests/test_torch_gp_kron.py).
GRID_NLML_F64_RTOL = 1e-9
# float32 CG NLML against float32 schur NLML on the card.  float32 CG stops at
# a relative residual of 20·eps32 = 2.4e-6 (its tolerance clamp), and on
# κ(K + σ²I) ≈ 1.7e3 its true residual drifts further from the recursive one;
# the JAX package's own float32 CG of grid8x512x512_exact lands 3.3e-5 from
# the float64 NLML (tools/grid_reference_jax.py).
GRID_CG_GAP_RTOL = 1e-4
# float32 predictive mean against the float64 one: a float32 Schur solve on
# κ(K + σ²I) up to ~1e3 loses ~κ·eps32 ≈ 1e-4 of the mean's scale.
GRID_MEAN_RTOL = 1e-3


def grid_data(name: str, sizes=None):
    """Grid points (float32, one (m_d, 1) array per dimension) and responses
    of a grid configuration, made from ``numpy.random.default_rng(0)``.
    ``sizes`` shrinks the lattice (the CPU tests' version)."""
    cfg = GRID_CONFIGS[name]
    sizes = tuple(sizes or cfg["sizes"])
    rng = np.random.default_rng(0)
    if name == "grid32x5_mixed":
        xg = [np.sort(rng.uniform(0, 3, m))[:, None].astype(np.float32) for m in sizes]
    else:
        xg = [np.arange(sizes[0], dtype=np.float32)[:, None]]
        xg += [((np.arange(m, dtype=np.float32) + 0.5) / m)[:, None] for m in sizes[1:]]
    # Drawn in chunks (the same stream as one draw) to keep host memory low.
    M, chunk = int(np.prod(sizes)), 1 << 20
    y = np.concatenate([rng.standard_normal(min(chunk, M - i)).astype(np.float32) for i in range(0, M, chunk)])
    return xg, y


def grid_test_points(xg, n: int, seed: int = 1):
    """Scattered points inside the grid's box, float32."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(g.min(), g.max(), n) for g in xg], axis=1).astype(np.float32)


def grid_model(name: str, xg, y, dtype, device, **overrides):
    import gp_grief_tpu_torch as gpt

    cfg = GRID_CONFIGS[name]
    kw = dict(cfg["model"], noise_var=cfg["noise_var"], **overrides)
    kerns = [gpt.make_kernel("rbf", lengthscale=ls) for ls in cfg["lengthscales"]]
    return gpt.GPKroneckerRegression(xg, y, kerns, dtype=dtype, device=device, **kw)


# (name, factor sizes, B): the shapes phase 6 holds K2/K3 to.
KRON_SHAPES = [
    ("kron_slab", "grid32x5", (32,) * 5, 1),
    ("kron_slab", "d5_4x16x8x16x8", (4, 16, 8, 16, 8), 1),
    ("kron_fused", "grid8x512x512", (8, 512, 512), 1),
    ("kron_fused", "ragged_d2_96x128", (96, 128), 1),
]
# Relative norm error of a kernel against its plain version (same contraction
# order, same rounding points): float32 summation order at "highest"; at
# "default" also the rare bf16 rounding such a difference tips over.
KRON_TOL = {"highest": 1e-5, "default": 2e-3}


def kron_bound(sizes, B, precision):
    """Least time for (⊗K_d)·V on an H100 SXM: every input read once, the
    output written once, against 2·M·B·Σm_d operations at the grade's peak."""
    M = int(np.prod(sizes))
    nbytes = 4 * (2 * M * B + sum(m * m for m in sizes))
    ops = 2.0 * M * B * sum(sizes)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[precision]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kron(card: str) -> dict:
    import torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk
    from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast

    summary = {}
    for kname, label, sizes, B in KRON_SHAPES:
        fn = tk.kron_matvec_slab if kname == "kron_slab" else tk.kron_matvec_fused
        M = int(np.prod(sizes))
        g = torch.Generator(device="cpu").manual_seed(0)
        fs = [(torch.randn((m, m), generator=g) / m**0.5).cuda() for m in sizes]
        # Several distinct vectors, cycled, so a small lattice is not timed
        # from L2 (8x512x512 is 8.4 MB of a 50 MB L2): >= 128 MB in all.
        nv = max(1, -(-(128 << 20) // (4 * M * B)))
        vs = [torch.randn((M, B), generator=g).cuda() for _ in range(nv)]
        for precision in ("highest", "default"):
            fast = precision == "default"
            kw = dict(precision=precision, **({"mid_dtype": torch.bfloat16} if fast and kname == "kron_slab" else {}))
            with torch.no_grad():
                got = fn(fs, vs[0], **kw)
                torch.cuda.synchronize()
                plain = tk.kron_chain_ref(fs, vs[0], fast=fast)
                exact = tk.kron_chain_ref([f.double() for f in fs], vs[0].double())
                rel = float(torch.linalg.norm((got - plain).double()) / torch.linalg.norm(plain.double()))
                rel_exact = float(torch.linalg.norm(got.double() - exact) / torch.linalg.norm(exact))
                abs_err = float((got - plain).abs().max())
                check(tuple(got.shape) == (M, B) and bool(torch.isfinite(got).all()), f"{kname} {label}: bad output")
                it = iter(range(1 << 30))
                ms = cuda_ms(lambda: fn(fs, vs[next(it) % nv], **kw))
                plain_ms = cuda_ms(lambda: tk.kron_chain_ref(fs, vs[next(it) % nv], fast=fast))
                chain_ms = cuda_ms(lambda: kron_matvec_fast(fs, vs[next(it) % nv], precision=precision, impl="xla"))
            bound_ms, bound_by = kron_bound(sizes, B, precision)
            emit({"phase": "kron", "kernel": kname, "shape": label, "sizes": list(sizes), "B": B,
                  "precision": precision, "passes": len(tk._hopper_plan(list(sizes), list(sizes), B)),
                  "rel_err_vs_plain": rel, "tol": KRON_TOL[precision], "rel_err_vs_exact": rel_exact,
                  "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "chain_ms": chain_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by, "gb_per_s": 2 * M * B * 4 / (ms * 1e-3) / 1e9,
                  "distinct_vectors": nv, "card": card})
            check(rel <= KRON_TOL[precision], f"{kname} {label} {precision}: rel err {rel:.3e} vs plain")
            check(rel_exact <= (2e-2 if fast else 1e-5), f"{kname} {label} {precision}: rel err {rel_exact:.3e} vs exact")
            entry = summary.setdefault(kname, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
            # The line's times: each kernel at its grid configuration's grade.
            if (label, precision) in (("grid32x5", "default"), ("grid8x512x512", "highest")):
                entry.update(ms=ms, plain_ms=plain_ms, chain_ms=chain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del fs, vs
        torch.cuda.empty_cache()
    return summary


def phase_grid(card: str, name: str) -> None:
    import torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk

    cfg = GRID_CONFIGS[name]
    xg, y = grid_data(name)
    xs_mean, xs_var = grid_test_points(xg, 10_000), grid_test_points(xg, 512, seed=2)

    m64 = grid_model(name, xg, y, torch.float64, "cuda", solver="schur")
    nl64, t64 = timed(m64.log_likelihood)
    mean64 = m64.predict(xs_mean, compute_var=False)
    del m64
    m32s = grid_model(name, xg, y, torch.float32, "cuda", solver="schur")
    nl32s, t32s = timed(m32s.log_likelihood)
    del m32s
    model = grid_model(name, xg, y, torch.float32, "cuda")
    kern = getattr(tk, cfg["kernel"])
    before = kern.launches
    nl32c, tcg = timed(model.log_likelihood)
    launched = kern.launches - before
    info = model.cg_info
    mean, t_mean = timed(lambda: model.predict(xs_mean, compute_var=False))
    (mean_v, var), t_var = timed(lambda: model.predict(xs_var))
    torch.cuda.empty_cache()

    ref = JAX_GRID_NLML_F64[name]
    rel64 = abs(-nl64 - ref) / abs(ref) if ref is not None else None
    gap = abs(nl32c - nl32s) / abs(nl32s)
    scale = float(mean64.abs().max())
    mean_err = float((mean.double() - mean64).abs().max()) / scale
    emit({"phase": "grid", "config": name, "sizes": list(cfg["sizes"]), "M": int(np.prod(cfg["sizes"])),
          "lengthscales": list(cfg["lengthscales"]), "noise_var": cfg["noise_var"], **cfg["model"],
          "nlml_f64_schur": -nl64, "jax_nlml_f64_schur": ref, "rel_err_f64": rel64,
          "rel_tol_f64": GRID_NLML_F64_RTOL, "nlml_f32_schur": -nl32s, "nlml_f32_cg": -nl32c,
          "cg_gap": gap, "cg_gap_tol": GRID_CG_GAP_RTOL, "cg_iterations": info.iterations,
          "cg_fallback_iterations": info.fallback_iterations,
          "cg_rel_residual": float(info.residual_norm.max()) / float(torch.linalg.norm(torch.as_tensor(y).double())),
          "kernel": cfg["kernel"], "kernel_launches_in_cg_nlml": launched,
          "mean_rel_err_vs_f64": mean_err, "mean_tol": GRID_MEAN_RTOL,
          "var_min": float(var.min()), "var_max": float(var.max()),
          "s": {"nlml_f64_schur": t64, "nlml_f32_schur": t32s, "nlml_f32_cg": tcg,
                "predict_mean_10k": t_mean, "predict_var_512": t_var}, "card": card})
    check(ref is not None and rel64 <= GRID_NLML_F64_RTOL, f"{name}: f64 schur NLML {-nl64} vs JAX {ref}")
    check(gap <= GRID_CG_GAP_RTOL, f"{name}: f32 CG NLML {nl32c} vs schur {nl32s} (gap {gap:.3e})")
    check(launched > 0, f"{name}: the CG NLML never launched {cfg['kernel']}")
    check(mean.shape == (10_000,) and bool(torch.isfinite(mean).all()), f"{name}: bad predictive mean")
    check(var.shape == (512,) and bool(torch.isfinite(var).all() and (var > 0).all()), f"{name}: bad variance")
    check(mean_err <= GRID_MEAN_RTOL, f"{name}: f32 mean off the f64 mean by {mean_err:.3e} of its scale")


def main() -> int:
    import torch

    # Phase 1: device.  There is no CPU path.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from gp_grief_tpu_torch.ops.cuda import _build, phi_fused  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's dots are full float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # Phase 2: build the kernels from the checkout's sources.
    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines() if "ptxas info" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    # Phase 3: K1 against its plain version.
    k1 = phase_kernel(card)
    # Phase 6 (kernels K2/K3 against their plain version) runs here, before
    # the paths, so a wrong kernel stops the script early.
    kron = phase_kron(card)

    from gp_grief_tpu_torch.ops.cuda import kron_matvec_fused, kron_matvec_slab

    # Phases 4-5: the GP-GRIEF path.  Count launches over exactly these runs.
    phi_fused.launches = kron_matvec_slab.launches = kron_matvec_fused.launches = 0
    phase_kin40k(card)
    phase_uci2m(card)
    k1_launches = phi_fused.launches
    check(k1_launches > 0, "the GP-GRIEF path never launched K1")

    # Phase 7: the grid GP path.
    phi_fused.launches = kron_matvec_slab.launches = kron_matvec_fused.launches = 0
    for name in GRID_CONFIGS:
        phase_grid(card, name)
    k2_launches, k3_launches = kron_matvec_slab.launches, kron_matvec_fused.launches
    check(k2_launches > 0 and k3_launches > 0, "the grid path never launched K2 or K3")

    def kron_entry(name, replaces, launches):
        k = kron[name]
        return {"name": name, "route": "cuda", "source": "gp_grief_tpu_torch/csrc/kron_pass.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None, "chain_ms": k["chain_ms"]}

    print(card, flush=True)
    emit({"kernels": [
        {"name": "phi_fused", "route": "cuda", "source": "gp_grief_tpu_torch/csrc/phi_fused.cu",
         "replaces": "gp_grief_tpu/ops/pallas/phi_pallas.py:93", "launches": k1_launches,
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        kron_entry("kron_slab", "gp_grief_tpu/ops/pallas/kron_pallas.py:1094", k2_launches),
        kron_entry("kron_fused", "gp_grief_tpu/ops/pallas/kron_pallas.py:1036", k3_launches),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
