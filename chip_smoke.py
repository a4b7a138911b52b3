#!/usr/bin/env python3
"""Drive the PyTorch port's GP-GRIEF main path once on one NVIDIA GPU.

Usage, from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script exits
non-zero without printing the final line:

1. device  — a CUDA device must exist; prints its name and power limit.
2. build   — compiles the port's CUDA kernels from gp_grief_tpu_torch/csrc/.
3. kernel  — K1 (the fused Φ assembly) against its plain PyTorch version on
             the card, float32 and float64, at the main path's shapes (d100's
             (100, 1000, 10, 300) among them) and one ragged shape; two
             launches bit-identical; CUDA-event times of
             both and the kernel's device time, beside the bound (at the
             FP32 rate outside the tensor cores) and the same work's bound
             at 3xTF32's tensor-core rate.
4. kin40k  — the kin40k_synth config (benchmarks/run_configs.py:kin40k):
             first its float64 NLML and gradient at the initial parameters
             against the JAX package's; then, twice, end to end through
             ``GPGriefModel``: 150 Adam steps training the kernel
             hyperparameters, refresh_basis, 200 reweight steps, predict.
             The two runs must agree bit for bit, and the predictions are
             held to a recorded JAX run of the same config.
5. uci2m   — the uci2m_synth config at n = 2M
             (benchmarks/run_configs.py:uci2m): chunked statistics, 150
             reweight steps, predict on 100k points; then its iterative NLML
             (CG + SLQ, rank-300 whitening, 8 probes) on the full 1.9M-row
             operator, Φ built by K1, held to the closed form, profiled
             (wall, device time, idle share, peak memory).
   configs — sine1d, grid3d and d100 through gp_grief_tpu_torch.run_configs
             in float64, held to a recorded float64 JAX run of each
             (JAX_CONFIGS); d100 launches K1.
6. kron    — K2 (kron_matvec_slab) and K3 (kron_matvec_fused) against their
             plain version on the card, both grades, at the grid
             configurations' lattices, one d=5 lattice and one ragged d=2
             lattice; CUDA-event times of the kernel, the plain version and
             the port's cyclic torch.matmul chain, beside the bound, and the
             device time of each kernel member (``members``).  Then SKI's
             lattice Q/Qᵀ (X3, the exact grade at (I_8 ⊗ 32^4)): its output's
             sha256 against X3_DIGEST, and its times.
7. grid    — the two grid configurations (GRID_CONFIGS) end to end through
             ``GPKroneckerRegression``: float64 schur NLML against a recorded
             float64 JAX run, float32 CG NLML against float32 schur, the
             kernel launches and the refined solve's exact applies during
             the CG NLML, and predict (mean on 10,000 points, variance on
             512).
8. ski_kernel — K4 (interp_wt) and K5 (wtw_stencil) against their plain
             versions on the card, float32 and float64, at the SKI
             configurations' shapes and one ragged d=3 lattice; two launches
             bit-identical, and K5's window member bit-identical to its cell
             member (the member each shape's plan picks is printed);
             CUDA-event times of the kernel, the plain version and one
             torch.sparse.mm of the same sparse matrix, beside the bound.
9. ski     — the two SKI configurations (SKI_CONFIGS) end to end through
             ``GPSKIRegression``.  First float64, with the numpy probes of
             tools/ski_reference_f64.json: the NLML and exact predictions
             (256 points) at that file's size against the JAX package's
             float64 values, then the NLML and predictions (mean on 10,000
             points, exact variance on 256) at full size.  Then float32 at
             full size: the NLML with the same probes, the mean and variance
             at the same points, each held to the card's float64; the NLML
             as a user calls it, profiled (wall, device time, idle share,
             launches); plan build times; LOVE on ski100k_data.

10. kron_axes — K6-K8 against their plain versions at the 32⁵ shapes (with
             each kernel member's device time), and K7 as the operator of a
             float32 CG solve at grid32x5_mixed.
11. grid_train — both grid configurations trained through CG: the float32
             NLML gradient (the CG implicit gradient) against the float64
             gradient with the Schur solve, then 5 Adam steps twice from the
             same start (the runs bit-identical, the NLML lower), per step
             wall, device time, idle share, peak memory and K2/K3 launches.
12. ski_train — each SKI configuration: its float64 NLML gradient at
             tools/ski_train_reference_f64.json's size and probes against the
             JAX package's; then ``optimize_segmented`` at full size in
             float32, twice from the same start per variant (ski1m_lattice
             with float32 and with bf16 step solves, ski100k_data with the data
             solver, K4 as W's adjoint), the runs bit-identical and the NLML
             lower, per step solve and gradient wall, device time, idle share,
             peak memory, CG iterations and launches; ski1m_lattice's
             ``log_likelihood_segmented`` against ``log_likelihood``.
13. gp_iter — ``GPRegression``'s iterative path, matrix-free, on
             benchmarks/exp_r15_train500k.py's recipe (GP_ITER): float64 at
             n = 4096 with the JAX package's numpy probes against
             tools/gp_iterative_reference_f64.json (segmented NLML, loss and
             gradient, one optimize_segmented step, predict); gp40k_matfree
             in float32 against the float64 Cholesky model on the card (the
             segmented NLML fused and separate, the loss and gradient,
             predict, mixed16 (with its exact applies), 5 Adam steps of
             optimize and 3 of
             optimize_segmented, each twice bit for bit and the Cholesky NLML
             lower after), with wall, device time, idle share, peak memory,
             CG iterations and one apply's device time beside its bound
             (device time from NVML's busy share: BusySampler);
             gp500k_matfree (one apply at n = 500k against float64 rows,
             then one segmented NLML at GP500K_NLML_N); optimize_segmented
             at GP_ITER_TRAIN_N (PERF.md §4 gives the cuts).
14. the rest of the public surface, inside phases 5 and 7:
    a. gp_web — after uci2m's training: the trained model's basis assembled
             into Φ (1.9M x 400, ~3 GB) and Φ* (100k test points) through
             ``kernels.grief.phi`` over ``stats_chunk`` row chunks (K1),
             ``GPweb`` on Φ, its NLML at the start, 150 Adam steps and
             predict held to the GRIEF model's own (GP_WEB_RTOL), the rmse
             to UCI2M_RMSE_MAX; Φ freed before the iterative NLML.
    c. surface — ``python -m gp_grief_tpu_torch checkgrad`` on the card,
             a ``save_pytree``/``load_pytree`` round trip of the uci2m model
             and its Adam state (the NLML bit for bit), a
             ``utils.profiling.trace`` of one GPweb predict, and
             ``ops.select_rows_t`` with repeated indices twice, bit for bit.
    b. kron_segmented — in phase 7, each grid configuration's
             ``log_likelihood_segmented()`` at full size, twice (bit for
             bit), held to the float64 Schur NLML at GRID_CG_GAP_RTOL (K3 at
             grid8x512x512_exact; the chain at grid32x5_mixed).
15. parallel — the multi-device layer (gp_grief_tpu_torch.parallel) on
             ranks spawned by ``parallel.launch.spawn``: world 2 on gloo with
             both ranks on cuda:0, then world 1 on NCCL (PARALLEL_RUNS).
             uci2m_synth through ``ShardedGPGriefModel`` (NLML and gradient
             at init against ``GPGriefModel(opt_kernel_params=True)`` on the
             card, 3 Adam steps twice bit for bit, predict at 100k against
             the single-device model at the trained parameters; K1 per
             rank); grid8x512x512_exact through
             ``GPKroneckerRegression(mesh=)`` against the float64 Schur NLML
             (K3 per rank); ski1m_lattice (also ``log_likelihood_segmented``
             and one ``optimize_segmented`` step) and ski100k_data through
             ``ShardedGPSKIRegression`` against phase 9's single-device
             float32 NLML with the same probes (K5 / K4 per rank).  One line
             per case: each rank's wall, device time of one profiled NLML,
             peak memory, collectives (calls, bytes, host seconds) and
             launches, and each gap beside its limit (PARALLEL_RTOL).
16. bench  — ``python -m gp_grief_tpu_torch bench`` on the card (a
             subprocess): the Kronecker matvec's effective GB/s at 5 × 32
             on K2 at "default" (its mma tile member) and "highest" (its
             exact tile member) against a stream measured in the same run;
             exit 0, finite positive rates, both grades within the bench's
             limits of float64 (REL_ERR_MAX), route "slab", K2's launches
             and exact-tile launches grown; its JSON line printed with the
             card.

Then the ``nvidia-smi`` name/power-limit line, one ``{"kernels": [...]}``
line (K1 launches from phases 4-5 (14a among them) and configs,
K2/K3 from phase 7 (14b among them), K4/K5 from
phase 9's float32 runs, K6-K8 from phase 10; ``training_launches`` from
phases 11-12; phase 13 launches none; ``parallel_launches``, the ranks' sum
over phase 15; K2's ``bench_launches``, the bench process's over phase 16)
and, last, ``{"ok": true, "device": {...}}``.  This script imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The configurations of benchmarks/run_configs.py as the port's runner builds
# them: data, models, recipes.
from gp_grief_tpu_torch import run_configs as rc  # noqa: E402
from gp_grief_tpu_torch.run_configs import kin40k_data, uci2m_data  # noqa: E402

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
# uci2m's iterative NLML (8 probes, rank-300 whitening) against its closed
# form, relative.  The JAX package recorded UCI2M_JAX_GAP at this operating
# point (benchmarks/RESULTS_r13.md:65).  The estimate is random in its
# probes: on an H100 the port gave 2.36e-5 with the default generator and
# 1.73e-5 with seed 1 (PERF.md §6, PR 8); the limit is four times the larger.
UCI2M_GAP_MAX = 1e-4
UCI2M_JAX_GAP = 2.2e-5

# K1 error, per element, relative to Π_d Σ_k |B_dk S_kj| (the scale of the
# rounding error of a product of d m-deep dots): both sides round each of
# ~d + m terms once, so float32 stays near 24·6e-8 ≈ 1.4e-6 at m = 16;
# float64 near 24·1.1e-16.
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}

# H100 SXM peaks (NVIDIA's data sheet, dense): memory rate, and the
# operation rate of each grade.  "highest" (float32 accuracy) is the fastest
# way the card reaches it: three TF32 tensor-core products per product
# (3xTF32), 495e12 / 3, above the 67e12 of FP32 FMA outside the tensor cores,
# so a bound reads the same work whichever unit a kernel runs it on; bf16 for
# "default".  "fp32" is the CUDA cores' rate: K1's, which keeps plain FP32
# FMA chains for their bits and so runs its operations there.
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"highest": 495e12 / 3, "default": 989e12, "fp32": 67e12}

# (name, d, n, m, p): the shapes the main path hands K1.  uci2m's stats
# chunk is also each row chunk of its iterative NLML's Φ; d100's is its
# whole Φ (statistics and predict on the training rows).
KERNEL_SHAPES = [
    ("kin40k_stats", 8, 30000, 16, 400),
    ("kin40k_predict", 8, 10000, 16, 400),
    ("uci2m_stats_chunk", 10, 131072, 10, 400),
    ("d100_stats", 100, 1000, 10, 300),
    ("ragged", 5, 4099, 37, 211),
]
# The data box and lengthscale of K1's operands where a shape's config sets
# them (run_configs.d100: x in [0, 1]^100, RBF lengthscale 1.5); else
# [-1, 1] and 0.7.
KERNEL_OPERANDS = {"d100_stats": dict(box=(0.0, 1.0), lengthscale=1.5)}


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


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` in milliseconds: the ``torch.profiler``
    sum of its kernels over ``reps`` calls, divided by ``reps``.  Beside
    :func:`cuda_ms` it shows how much of a call's event time is the host's."""
    return device_split(fn, reps, warmup)[0]


# csrc/kron_pass.cu's members, by the kernel names the profiler reports.
KRON_MEMBERS = (("kron_exact_tile_kernel", "exact_tile"), ("kron_mma_tile_kernel", "mma_tile"),
                ("kron_tile_kernel", "fp32_tile"), ("kron_wide_kernel", "wide"))


def device_split(fn, reps: int = 20, warmup: int = 3) -> tuple:
    """:func:`device_ms`, and the device ms of one call by Kronecker member
    (KRON_MEMBERS; "other" for every other kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    members = {}
    for name, ms, _ in device_rows(prof):
        member = next((m for k, m in KRON_MEMBERS if k in name), "other")
        members[member] = members.get(member, 0.0) + ms / reps
    return device_items(prof)[0] / reps, members


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


def phi_operands(d, n, m, p, dtype, device, seed=0, box=(-1.0, 1.0), lengthscale=0.7):
    """K1's operands as the main path builds them: RBF cross-covariances of
    points uniform in ``box`` to an m-point grid per dimension, and the
    scaled top-p eigenvector selections of the grid Grams."""
    import torch
    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch.kernels.grief import _phi_fused_operands, build_basis
    from gp_grief_tpu_torch.kernels.grid import cross_cov_grid

    x = np.random.default_rng(seed).uniform(*box, size=(n, d))
    grid = gpt.InducingGrid.build(x, mbar=m)
    xg = [torch.as_tensor(g, dtype=dtype, device=device) for g in grid.xg]
    kerns = [gpt.make_kernel("rbf", lengthscale=lengthscale, dtype=dtype, device=device) for _ in range(d)]
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
                B, S = phi_operands(d, n, m, p, dtype, "cuda", **KERNEL_OPERANDS.get(name, {}))
                got = phi_fused(B, S)
                again = phi_fused(B, S)
                torch.cuda.synchronize()
                identical = bool(torch.equal(got, again))
                ref = phi_fused_ref(B, S)
                scale = phi_fused_ref(B.abs(), S.abs()).clamp_min(torch.finfo(dtype).tiny)
                diff = (got - ref).abs()
                rel = float((diff / scale).max())
                abs_err = float(diff.max())
                check(tuple(got.shape) == (n, p) and bool(torch.isfinite(got).all()),
                      f"K1 {name} {tag}: bad output")
                ms = cuda_ms(lambda: phi_fused(B, S))
                dev_ms = device_ms(lambda: phi_fused(B, S))
                plain_ms = cuda_ms(lambda: phi_fused_ref(B, S))
            # 2·n·p·d·m operations against B, S read once and Φ written once.
            # K1 keeps its bits with plain FMA chains on the CUDA cores, so its
            # operations are held to the FP32 rate outside the tensor cores;
            # `bound_3xtf32_ms` is the same work at 3xTF32's tensor-core rate.
            t_ops = 2.0 * n * p * d * m / H100_FLOPS["fp32"]
            t_bytes = (4.0 if tag == "float32" else 8.0) * (d * n * m + d * m * p + n * p) / H100_BYTES_PER_S
            bound_3xtf32_ms = max(2.0 * n * p * d * m / H100_FLOPS["highest"], t_bytes) * 1e3
            emit({"phase": "kernel", "kernel": "phi_fused", "shape": name, "d": d, "n": n, "m": m,
                  "p": p, "dtype": tag, "max_rel_err": rel, "max_abs_err": abs_err,
                  "tol": KERNEL_TOL[tag], "tol_reason": "per element, relative to prod_d sum_k |B S|",
                  "two_launches_identical": identical, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                  "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                  "bound_3xtf32_ms": bound_3xtf32_ms, "card": card})
            check(rel <= KERNEL_TOL[tag], f"K1 {name} {tag}: rel err {rel:.3e} > {KERNEL_TOL[tag]}")
            check(identical, f"K1 {name} {tag}: two launches differ")
            if tag == "float32":
                summary["max_abs_err"] = max(summary["max_abs_err"], abs_err)
                if name == "kin40k_stats":
                    summary.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                                   bound_by="operations" if t_ops >= t_bytes else "bytes")
                elif name == "uci2m_stats_chunk":
                    summary.update(uci2m_chunk_ms=ms, uci2m_chunk_device_ms=dev_ms)
                elif name == "d100_stats":
                    summary.update(d100_ms=ms, d100_device_ms=dev_ms)
            del B, S, got, again, ref, scale, diff
            torch.cuda.empty_cache()
    return summary


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kin40k_model(xtr, ytr, dtype):
    return rc.kin40k_model(xtr, ytr, dtype, "cuda")


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


def uci2m_build(xtr, ytr):
    """uci2m_synth's model build on the card: the grid, the basis and the
    chunked statistics (K1 on every chunk)."""
    return rc.uci2m_model(xtr, ytr, "cuda")


def phase_uci2m(card: str) -> None:
    import torch
    from gp_grief_tpu_torch.ops.cuda import phi_fused

    xtr, ytr, xte, fte = uci2m_data()
    n_te, d = xte.shape
    before = phi_fused.launches
    model, t_build = timed(lambda: uci2m_build(xtr, ytr))
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
    web, Phis = phase_gp_web(card, model, res, t_train, xte, fte)
    phase_surface(card, model, res, web, Phis)
    del web, Phis
    torch.cuda.empty_cache()
    phase_uci2m_iterative(card, model)


# Phase 14a: GPweb over the trained uci2m model's own basis.  Its start
# (log_w zeros, the same noise) is that model's start and reweight training
# leaves the basis alone, so GPweb's 150 Adam steps are the model's own run:
# the same K1 chunks, the same GEMM shapes and the same O(p³) NLML.  Gaps
# relative to the model's values (NLML trace, parameters) and to the scale of
# its predictive mean and variance; on an H100 every gap measured 0 (PERF.md
# §6), so the limits hold them bit for bit.
GP_WEB_TRAIN = dict(optimizer="adam", max_iters=150, learning_rate=0.05)
GP_WEB_RTOL = {"nlml_start": 0.0, "nlml_trace": 0.0, "params": 0.0, "mean": 0.0, "var": 0.0}


def phase_gp_web(card: str, model, res, t_train_model: float, xte, fte):
    """Phase 14a: assemble the uci2m basis's Φ (1.9M x 400) and Φ* (the 100k
    test points) through the public ``kernels.grief.phi`` over
    ``stats_chunk`` row chunks (K1), build ``GPweb`` on Φ, hold its NLML at
    the start, 150 Adam steps and predictions to the GRIEF model's; Φ is
    freed before returning.  Returns the trained ``GPweb`` and Φ*."""
    import torch

    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch.kernels.grief import phi
    from gp_grief_tpu_torch.models.gp_grief import _to_tensor
    from gp_grief_tpu_torch.ops.cuda import phi_fused

    chunk, p = model.stats_chunk, model.n_eigs

    def assemble(x):
        out = torch.empty((x.shape[0], p), dtype=model.x.dtype, device=model.x.device)
        for s in range(0, x.shape[0], chunk):
            out[s : s + chunk] = phi(model._basis, model.kernels, model.xg, x[s : s + chunk], dims=model.dims,
                                     impl=model.phi_impl)
        return out

    xte_t = _to_tensor(xte, model.x.dtype, model.x.device)
    mean_m, var_m = model.predict(xte_t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    before = phi_fused.launches
    with torch.no_grad():
        Phi, t_phi = timed(lambda: assemble(model.x))
        Phis, t_phis = timed(lambda: assemble(xte_t))
    k1 = phi_fused.launches - before
    web, t_stats = timed(lambda: gpt.GPweb(Phi, model.y, noise_var=0.2, stats_chunk=chunk))
    phi_gb = Phi.numel() * Phi.element_size() / 1e9
    del Phi
    torch.cuda.empty_cache()
    nlml0 = -web.log_likelihood()
    rw, t_train = timed(lambda: web.optimize(**GP_WEB_TRAIN))
    (mean, var), t_pred = timed(lambda: web.predict(Phis))
    peak = torch.cuda.max_memory_allocated() - mem_before
    mean_np = mean.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mean_np - fte) ** 2)))
    trace_m = np.asarray(res.losses, dtype=np.float64)
    gaps = {"nlml_start": abs(nlml0 - trace_m[0]) / abs(trace_m[0]),
            "nlml_trace": float(np.max(np.abs(rw.losses - trace_m) / np.abs(trace_m))),
            "params": max(rel_err(web.log_w, model.log_w), rel_err(web.log_noise, model.log_noise)),
            "mean": rel_err(mean, mean_m), "var": rel_err(var, var_m)}
    identical = {"nlml_trace": bool(np.array_equal(rw.losses, trace_m)),
                 "params": bool(torch.equal(web.log_w, model.log_w) and torch.equal(web.log_noise, model.log_noise)),
                 "mean": bool(torch.equal(mean, mean_m)), "var": bool(torch.equal(var, var_m))}
    emit({"phase": "gp_web", "n": int(model.x.shape[0]), "p": p, "n_test": int(Phis.shape[0]), "stats_chunk": chunk,
          **GP_WEB_TRAIN, "phi_gb": phi_gb, "k1_launches": k1, "nlml_start": nlml0,
          "nlml": [float(rw.losses[0]), float(rw.losses[-1])], "rmse": rmse, "rmse_max": UCI2M_RMSE_MAX,
          "gaps_to_grief": gaps, "gap_tol": GP_WEB_RTOL, "bit_identical_to_grief": identical,
          "s": {"phi_assembly": t_phi, "phi_star_assembly": t_phis, "stats": t_stats, "train_150_steps": t_train,
                "grief_train_150_steps": t_train_model, "predict_100k": t_pred},
          "peak_gb_above_model": peak / 1e9, "card": card})
    check(k1 >= -(-int(model.x.shape[0]) // chunk) + 1, f"gp_web: Φ and Φ* launched K1 only {k1} times")
    check(rw.iterations == GP_WEB_TRAIN["max_iters"], f"gp_web training stopped at step {rw.iterations}")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all() and (var > 0).all()),
          "gp_web predict: non-finite or non-positive output")
    for key, tol in GP_WEB_RTOL.items():
        check(gaps[key] <= tol, f"gp_web: {key} off the GRIEF model's by {gaps[key]:.3e} (limit {tol})")
    check(rmse <= UCI2M_RMSE_MAX, f"gp_web rmse {rmse} > {UCI2M_RMSE_MAX}")
    return web, Phis


# Phase 14c: select_rows_t with repeated indices at this size, twice.
SELECT_ROWS_SHAPE = dict(k=1_000_000, m=100_000, cols=8)
SELECT_ROWS_RTOL = 1e-5


def phase_surface(card: str, model, res, web, Phis) -> None:
    """Phase 14c: the command line's ``checkgrad`` on the card (a
    subprocess), a checkpoint round trip of the uci2m GRIEF model and its
    Adam state (the NLML bit for bit), a ``utils.profiling.trace`` of one
    GPweb predict (a non-empty trace with the card's kernels in it), and
    ``ops.select_rows_t`` with repeated indices run twice (the same bits)."""
    import tempfile

    import torch

    from gp_grief_tpu_torch.ops import select_rows_t
    from gp_grief_tpu_torch.utils import load_pytree, save_pytree, trace

    out = {"phase": "surface"}
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "gp_grief_tpu_torch", "checkgrad", "--device", DEVICE],
                         capture_output=True, text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = cli.stdout.splitlines()
    out["checkgrad"] = {"returncode": cli.returncode, "last_line": lines[-1] if lines else "", "rows": len(lines) - 2,
                        "s": time.perf_counter() - t0}

    ll = model.log_likelihood()
    like = {"model": model, "opt": res.opt_state}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "uci2m.npz")
        save_pytree(path, like)
        out["checkpoint_bytes"] = os.path.getsize(path)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        with torch.no_grad():
            model.log_w.zero_()
            model.log_noise.add_(1.0)
        back = load_pytree(path, like)
        model.load_state_dict(back["model"])
        ll_back = model.log_likelihood()
        params_same = all(torch.equal(v, start[k]) for k, v in model.state_dict().items())
        opt_same = all(torch.equal(a, b) for i in res.opt_state["state"]
                       for a, b in zip(res.opt_state["state"][i].values(), back["opt"]["state"][i].values()))
        out["checkpoint"] = {"nlml": -ll, "nlml_restored": -ll_back, "params_identical": params_same,
                             "adam_state_identical": opt_same}

        logdir = os.path.join(tmp, "trace")
        with trace(logdir):
            web.predict(Phis)
        files = os.listdir(logdir)
        events = json.load(open(os.path.join(logdir, files[0])))["traceEvents"] if files else []
        out["trace"] = {"files": len(files), "bytes": sum(os.path.getsize(os.path.join(logdir, f)) for f in files),
                        "kernel_events": sum(1 for e in events if e.get("cat") == "kernel")}

    k, m, cols = SELECT_ROWS_SHAPE["k"], SELECT_ROWS_SHAPE["m"], SELECT_ROWS_SHAPE["cols"]
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    idx = torch.randint(0, m, (k,), device=DEVICE, generator=gen)
    u = torch.randn((k, cols), device=DEVICE, generator=gen)
    first, second = select_rows_t(idx, u, m), select_rows_t(idx, u, m)
    want = torch.zeros((m, cols), dtype=torch.float64).index_add_(0, idx.cpu(), u.double().cpu())
    lib = [torch.zeros((m, cols), device=DEVICE).index_add_(0, idx, u) for _ in range(2)]
    out["select_rows_t"] = {**SELECT_ROWS_SHAPE, "runs_identical": bool(torch.equal(first, second)),
                            "rel_err_vs_f64": rel_err(first, want), "tol": SELECT_ROWS_RTOL,
                            "ms": cuda_ms(lambda: select_rows_t(idx, u, m), reps=10),
                            "index_add_ms": cuda_ms(lambda: torch.zeros((m, cols), device=DEVICE).index_add_(0, idx, u),
                                                    reps=10),
                            "index_add_runs_identical": bool(torch.equal(lib[0], lib[1]))}
    emit({**out, "card": card})
    check(cli.returncode == 0 and out["checkgrad"]["last_line"] == "OK",
          f"checkgrad on the card: exit {cli.returncode}, {cli.stdout[-2000:]}{cli.stderr[-2000:]}")
    check(ll_back == ll and params_same and opt_same, "the uci2m checkpoint round trip changed the NLML or the state")
    check(out["trace"]["files"] == 1 and out["trace"]["bytes"] > 0 and out["trace"]["kernel_events"] > 0,
          "the GPweb predict trace is empty or holds no kernel of the card")
    check(out["select_rows_t"]["runs_identical"], "select_rows_t gave different bits in two runs")
    check(out["select_rows_t"]["rel_err_vs_f64"] <= SELECT_ROWS_RTOL, "select_rows_t is off its float64 sums")


def kernel_groups(items) -> dict:
    """A profile's device time by kind of kernel (ms): K1, the Kronecker
    members (K2/K3/K6-K8), K4, K5, GEMMs, reductions, elementwise updates,
    the rest."""
    groups = {}
    for it in items:
        name = it["name"].lower()
        kind = ("K1" if "phi_fused" in name else "kron_pass" if "kron_" in name else "K4" if "interp_wt" in name
                else "K5" if "wtw_" in name else "gemm" if any(k in name for k in ("gemm", "xmma", "cutlass"))
                else "reduce" if "reduce" in name else "elementwise" if "elementwise" in name else "other")
        groups[kind] = groups.get(kind, 0.0) + it["ms"]
    return groups


def phase_uci2m_iterative(card: str, model) -> None:
    """uci2m's iterative NLML at the trained optimum, on the full 1.9M-row
    operator (run_configs.UCI2M_ITERATIVE, benchmarks/run_configs.py:234-237),
    against the closed form.  The first call builds Φ (K1 in row chunks) and
    the rank-300 factor, profiled; a second call with other probes reuses
    them.  Then one operator apply and one whitening apply at the driver's
    batch (1 + probe_chunk rows), timed alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gp_grief_tpu_torch.ops.cuda import phi_fused
    from gp_grief_tpu_torch.ops.precond import check_whitening, lowrank_sqrt_ops

    ll_closed = model.log_likelihood()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    before = phi_fused.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ll_iter, wall = timed(lambda: model.log_likelihood_iterative_segmented(**rc.UCI2M_ITERATIVE))
    k1 = phi_fused.launches - before
    cg_iterations = model.cg_iterations
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated() - mem_before
    dev_total, items = device_items(prof, top=40)
    gap = abs(ll_iter - ll_closed) / abs(ll_closed)
    # Other probes, the prep reused: the solver alone, and the gap's spread.
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof1:
        ll_iter1, wall1 = timed(
            lambda: model.log_likelihood_iterative_segmented(generator=gen, **rc.UCI2M_ITERATIVE))
    dev1, items1 = device_items(prof1, top=40)
    gap1 = abs(ll_iter1 - ll_closed) / abs(ll_closed)
    Phi, w, sigma2, U, lam = model._iter_prep
    defect = check_whitening(U, lam, sigma2)
    _, white, _ = lowrank_sqrt_ops(U, lam, sigma2, layout="bm")
    vv = torch.randn((1 + rc.UCI2M_ITERATIVE["probe_chunk"], Phi.shape[0]), device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(2))
    with torch.no_grad():
        apply_ms = device_ms(lambda: ((vv @ Phi) * w[None, :]) @ Phi.T + sigma2 * vv)
        white_ms = device_ms(lambda: white(vv))
    emit({"phase": "uci2m_iterative", "n": int(Phi.shape[0]), "p": int(Phi.shape[1]), **rc.UCI2M_ITERATIVE,
          "nlml_closed": ll_closed, "nlml_slq_cg": ll_iter, "slq_cg_nlml_gap": gap, "gap_tol": UCI2M_GAP_MAX,
          "jax_gap": UCI2M_JAX_GAP, "nlml_slq_cg_seed1": ll_iter1, "slq_cg_nlml_gap_seed1": gap1,
          "cg_iterations": cg_iterations, "k1_launches": k1, "wall_ms": wall * 1e3, "device_ms": dev_total,
          "idle_share": 1 - dev_total / (wall * 1e3), "device_by_kind_ms": kernel_groups(items),
          "device_items": items[:12], "wall_ms_prep_reused": wall1 * 1e3, "device_ms_prep_reused": dev1,
          "idle_share_prep_reused": 1 - dev1 / (wall1 * 1e3), "device_by_kind_ms_prep_reused": kernel_groups(items1),
          "apply_device_ms": apply_ms, "whitening_device_ms": white_ms, "whitening_defect": defect,
          "peak_gb": peak / 1e9, "held_after_gb": held / 1e9, "card": card})
    check(np.isfinite(ll_iter) and np.isfinite(ll_iter1), "uci2m iterative NLML is not finite")
    check(k1 >= -(-int(Phi.shape[0]) // model.stats_chunk), f"uci2m's iterative Φ launched K1 {k1} times")
    check(gap <= UCI2M_GAP_MAX and gap1 <= UCI2M_GAP_MAX,
          f"uci2m SLQ+CG NLML off the closed form by {gap:.3e} / {gap1:.3e} (limit {UCI2M_GAP_MAX})")


# ---------------------------------------------------------------------------
# The small BASELINE configurations through the port's runner.
# ---------------------------------------------------------------------------

# A fresh float64 run of each through the JAX package on the CPU (jax 0.9.0,
# commit f0da5fd):
#     JAX_PLATFORMS=cpu python tools/configs_reference_jax.py
JAX_CONFIGS = {
    "sine1d": {"rmse": 0.01030411766071493, "rmse_exact": 0.00760693452240356,
               "parity_nlml_gap": 1.3184212832584308e-08, "parity_mean_gap": 1.183568798523993e-10,
               "nlml_grief": -829.7406218089686, "nlml_exact": -829.0846772587702},
    "grid3d": {"ll_schur": 5421.57860371499, "ll_cg": 5421.578603714919},
    "d100": {"ll": -813.2382239884367, "ll_opt": -560.4245389983322},
}
# Relative limits against JAX_CONFIGS, float64 on both sides.  Closed forms
# and the d100 reweighting (a smooth Adam path on fixed statistics) differ
# by rounding only (≤ 3.4e-15 through both packages on the CPU).  sine1d's
# two L-BFGS runs stop where their line searches (the port's strong-Wolfe,
# optax's) reach the gradient tolerance: the trained NLMLs agree to ~3e-12
# on the CPU, the test rmse, which moves with the parameters, to ~1e-6.
CONFIG_RTOL = {"ll_schur": 1e-9, "ll_cg": 1e-9, "ll": 1e-9, "ll_opt": 1e-9, "nlml_grief": 1e-9,
               "nlml_exact": 1e-9, "rmse": 1e-4, "rmse_exact": 1e-4}
# sine1d's exact-GP parity (GP-GRIEF with the full basis on grid data
# against GPRegression), absolute: the predictive means agree to ~1e-10.
# The NLMLs differ by the GRIEF model's own 1.3e-8 (the JAX package gives
# JAX_CONFIGS' value too: its dim_noise_var jitter on a 100-point grid), so
# that gap is held to 1.5 times the JAX package's.
SINE1D_PARITY_MAX = {"parity_nlml_gap": 2e-8, "parity_mean_gap": 1e-8}


def phase_configs(card: str) -> None:
    """sine1d, grid3d and d100 through ``gp_grief_tpu_torch.run_configs`` on
    the card in float64, held to JAX_CONFIGS; d100 must launch K1."""
    from gp_grief_tpu_torch.ops.cuda import kron_matvec_fused, kron_matvec_slab, phi_fused

    kernels = {"K1": phi_fused, "K2": kron_matvec_slab, "K3": kron_matvec_fused}
    for name, ref in JAX_CONFIGS.items():
        before = {k: fn.launches for k, fn in kernels.items()}
        out, wall = timed(lambda: rc.ALL[name](device=DEVICE))
        launched = {k: fn.launches - before[k] for k, fn in kernels.items()}
        errs = {k: abs(out[k] - v) / abs(v) for k, v in ref.items() if k in CONFIG_RTOL}
        emit({"phase": "configs", "config": name, "dtype": "float64", "line": json.loads(rc.line(name, out)),
              **{k: out[k] for k in ref}, "jax": ref, "rel_err_vs_jax": errs,
              "rtol": {k: CONFIG_RTOL[k] for k in errs}, "launches": launched, "s": wall, "card": card})
        for k, err in errs.items():
            check(err <= CONFIG_RTOL[k], f"{name} {k}: {out[k]} vs JAX {ref[k]} (rel {err:.3e})")
        if name == "sine1d":
            for k, limit in SINE1D_PARITY_MAX.items():
                check(out[k] <= limit, f"sine1d {k} {out[k]:.3e} > {limit}")
        if name == "d100":
            check(out["pred_finite"], "d100: non-finite predictions")
            check(launched["K1"] > 0, "d100 never launched K1")


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
    # Two 1024-deep wide passes: the exact grade's 3xTF32 error grows with
    # the depth, and the copied gate sends (I_8, 1024^2) to K3.
    ("kron_fused", "depth1024_8x1024x1024", (8, 1024, 1024), 1),
    ("kron_fused", "ragged_d2_96x128", (96, 128), 1),
]
# Relative norm error of a kernel against its plain version (same contraction
# order, same rounding points): float32 summation order at "highest"; at
# "default" also the rare bf16 rounding such a difference tips over.
KRON_TOL = {"highest": 1e-5, "default": 2e-3}


def kron_bound(sizes, B, precision, outs=None, lead=1):
    """Least time for (I_lead ⊗ (⊗K_d))·V, factors (o_d, m_d), V (lead·Πm_d,
    B), float32, on an H100 SXM: the input, the factors and the output moved
    once, against the operations of the chain (last axis first; 2·M·B·Σm_d for
    square factors) at the grade's peak.  A single factor is counted as the
    dense matrix it is (K6's W = I_G ⊗ K)."""
    outs = list(outs or sizes)
    nbytes = 4 * (lead * B * (int(np.prod(sizes)) + int(np.prod(outs))) + sum(o * m for o, m in zip(outs, sizes)))
    ops = 2.0 * lead * B * sum(int(np.prod(sizes[:t])) * outs[t] * sizes[t] * int(np.prod(outs[t + 1 :]))
                               for t in range(len(sizes)))
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FLOPS[precision]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kron_einsum(fs, x):
    """The library yardstick of K2, K3 and K7: ``(⊗K_d)·x`` for ``x`` ``(M,)``
    or ``(M, B)`` as one ``torch.einsum`` in float32, shaped ``(o_1, …, o_d[,
    B])``.  ``x`` comes first, so that even without opt_einsum each factor
    contracts one axis of it.  Timed only; no path of the port calls it."""
    import torch

    a, o = "abcdefgh"[: len(fs)], "ijklmnop"[: len(fs)]
    b = "z" if x.ndim == 2 else ""
    spec = f"{a}{b}," + ",".join(f"{o[t]}{a[t]}" for t in range(len(fs))) + f"->{o}{b}"
    return torch.einsum(spec, x.reshape(*(int(f.shape[1]) for f in fs), *x.shape[1:]), *fs)


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
                dev_ms, members = device_split(lambda: fn(fs, vs[next(it) % nv], **kw))
                before = fn.exact_tile_launches
                fn(fs, vs[0], **kw)
                exact_passes = fn.exact_tile_launches - before
                plain_ms = cuda_ms(lambda: tk.kron_chain_ref(fs, vs[next(it) % nv], fast=fast))
                chain_ms = cuda_ms(lambda: kron_matvec_fast(fs, vs[next(it) % nv], precision=precision, impl="xla"))
                library_ms = cuda_ms(lambda: kron_einsum(fs, vs[next(it) % nv]))
            bound_ms, bound_by = kron_bound(sizes, B, precision)
            emit({"phase": "kron", "kernel": kname, "shape": label, "sizes": list(sizes), "B": B,
                  "precision": precision, "passes": len(tk._hopper_plan(list(sizes), list(sizes), B)),
                  "rel_err_vs_plain": rel, "tol": KRON_TOL[precision], "rel_err_vs_exact": rel_exact,
                  "max_abs_err": abs_err, "ms": ms, "device_ms": dev_ms, "members": members,
                  "exact_tile_passes": exact_passes, "plain_ms": plain_ms, "chain_ms": chain_ms,
                  "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "gb_per_s": 2 * M * B * 4 / (ms * 1e-3) / 1e9,
                  "distinct_vectors": nv, "card": card})
            check(rel <= KRON_TOL[precision], f"{kname} {label} {precision}: rel err {rel:.3e} vs plain")
            check(rel_exact <= (2e-2 if fast else 1e-5), f"{kname} {label} {precision}: rel err {rel_exact:.3e} vs exact")
            entry = summary.setdefault(kname, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
            # The line's times: each kernel at its grid configuration's grade.
            if (label, precision) in (("grid32x5", "default"), ("grid8x512x512", "highest")):
                entry.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, chain_ms=chain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        del fs, vs
        torch.cuda.empty_cache()
    summary["kron_slab"]["x3"] = phase_kron_x3(card)
    return summary


# sha256 of the exact grade's float32 output at SKI's lattice Q/Qᵀ shape (X3:
# (I_8 ⊗ 32^4), the inputs of x3_operands), as recorded on an H100 before the
# tensor-core tile member was added; tests/test_torch_kron_cuda.py holds the
# same digest.  The exact grade keeps these bits.
X3_DIGEST = "264a185a3895fafbb9e264b2dee9f05f525616b2233747ca012eb683bc1ce922"


def x3_operands():
    """(I_8, Q_1..Q_4) with Q_d orthogonal 32 x 32 and v (8·32^4,), float32
    on the card, drawn from a CPU generator seeded 4."""
    import torch

    g = torch.Generator().manual_seed(4)
    Qs = [torch.linalg.qr(torch.randn((32, 32), generator=g, dtype=torch.float64))[0].float() for _ in range(4)]
    fs = [torch.eye(8).cuda(), *[Q.contiguous().cuda() for Q in Qs]]
    v = torch.randn((8 * 32**4,), generator=g, dtype=torch.float64).float().cuda()
    return fs, v


def phase_kron_x3(card: str) -> dict:
    """X3 through kron_matvec_fast (K2 at the exact grade): the output's
    sha256 against X3_DIGEST, the gaps to the plain version and to float64,
    and the times as phase 6 takes them."""
    import hashlib

    import torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk
    from gp_grief_tpu_torch.ops.kron_fast import X3, kron_matvec_fast

    fs, v = x3_operands()
    M = int(v.numel())
    nv = max(1, -(-(128 << 20) // (4 * M)))
    g = torch.Generator(device="cpu").manual_seed(0)
    vs = [v] + [torch.randn((M,), generator=g).cuda() for _ in range(nv - 1)]
    run = lambda x: kron_matvec_fast(fs, x, precision=X3)  # noqa: E731
    with torch.no_grad():
        before = tk.kron_matvec_slab.exact_tile_launches
        got = run(v)
        torch.cuda.synchronize()
        exact_passes = tk.kron_matvec_slab.exact_tile_launches - before
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        plain = tk.kron_chain_ref(fs, v[:, None])[:, 0]
        exact = tk.kron_chain_ref([f.double() for f in fs], v.double()[:, None])[:, 0]
        rel = float(torch.linalg.norm((got - plain).double()) / torch.linalg.norm(plain.double()))
        rel_exact = float(torch.linalg.norm(got.double() - exact) / torch.linalg.norm(exact))
        it = iter(range(1 << 30))
        ms = cuda_ms(lambda: run(vs[next(it) % nv]))
        dev_ms, members = device_split(lambda: run(vs[next(it) % nv]))
        plain_ms = cuda_ms(lambda: tk.kron_chain_ref(fs, vs[next(it) % nv][:, None]))
        library_ms = cuda_ms(lambda: kron_einsum(fs, vs[next(it) % nv]))
    bound_ms, bound_by = kron_bound([8] + [32] * 4, 1, "highest")
    out = {"sha256": digest, "want_sha256": X3_DIGEST, "rel_err_vs_plain": rel, "rel_err_vs_exact": rel_exact,
           "max_abs_err": float((got - plain).abs().max()), "ms": ms, "device_ms": dev_ms, "members": members,
           "exact_tile_passes": exact_passes, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kron", "kernel": "kron_slab", "shape": "x3_I8_32x4", "precision": X3, **out, "card": card})
    check(digest == X3_DIGEST, f"X3: the exact grade's bits moved (sha256 {digest})")
    check(rel <= KRON_TOL["highest"] and rel_exact <= 1e-5, f"X3: rel err {rel:.3e} / {rel_exact:.3e}")
    del fs, v, vs, got, plain, exact
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# SKI configurations (GPSKIRegression) and kernels K4/K5.
# ---------------------------------------------------------------------------

SKI_CONFIGS = {
    # benchmarks/exp_r4_ski_precond.py:29-44: n = 100,000 scattered points in
    # [0, 4]^4 on a 32^4 lattice (M = 1,048,576), the data-space solver with
    # rank-256 deflation.  Every operator apply runs K4 at (9, 100k) -> (9, 1M).
    "ski100k_data": dict(
        n=100_000, m=32, box=(0.0, 4.0), lengthscale=0.8, noise_var=0.1,
        model=dict(solver="data", num_probes=8, lanczos_iters=30, cg_iters=300, cg_tol=1e-6,
                   precond_rank=256, cg_precision="exact"),
        kernel="interp_wt",
    ),
    # benchmarks/exp_r9_stencil_e2e.py:24-30, 58-67: n = 1,000,000 points in
    # [0, 1]^4 on a 32^4 lattice, the whitened lattice dual with the WtW
    # stencil.  Every whitened apply runs K5; W^T y runs K4 once.
    "ski1m_lattice": dict(
        n=1_000_000, m=32, box=(0.0, 1.0), lengthscale=0.3, noise_var=0.05,
        model=dict(solver="lattice", num_probes=8, lanczos_iters=30, cg_iters=300, cg_tol=1e-6,
                   wtw_stencil=True),
        kernel="wtw_stencil",
    ),
}
SKI_D = 4


def ski_data(name: str, n=None, m=None):
    """Points, responses (float32) and grid (one (m, 1) array per dimension)
    of a SKI configuration, from ``numpy.random.default_rng(0)`` as in its
    benchmark script.  ``n``/``m`` shrink it (the CPU tests' and the float64
    reference's sizes)."""
    cfg = SKI_CONFIGS[name]
    n = int(n or cfg["n"])
    m = int(m or cfg["m"])
    lo, hi = cfg["box"]
    rng = np.random.default_rng(0)
    x = rng.uniform(lo, hi, size=(n, SKI_D)).astype(np.float32)
    if name == "ski100k_data":
        f = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.3 * x[:, 2] - 0.2 * x[:, 3] ** 2
        y = (f + 0.1 * rng.standard_normal(n)).astype(np.float32)
    else:
        f = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3]
        y = (f + 0.05 * rng.standard_normal(n)).astype(np.float32)
    xg = [np.linspace(lo, hi, m, dtype=np.float32)[:, None] for _ in range(SKI_D)]
    return x, y, xg


def ski_test_points(name: str, count: int, seed: int = 1):
    """Scattered test points inside a SKI configuration's box, float32."""
    lo, hi = SKI_CONFIGS[name]["box"]
    return np.random.default_rng(seed).uniform(lo, hi, size=(count, SKI_D)).astype(np.float32)


def ski_probe(call: int, shape) -> np.ndarray:
    """The ``call``-th Rademacher probe matrix of one NLML evaluation (call 0:
    the CG probes, call 1: the SLQ probes), float64, from numpy.  Both
    packages are handed these in parity runs (tools/ski_reference_jax.py
    patches ``jax.random.rademacher``; the port's draw is
    ``gp_grief_tpu_torch.ops.lanczos.rademacher``)."""
    rng = np.random.default_rng([20261016, call])
    return (2.0 * rng.integers(0, 2, size=shape) - 1.0).astype(np.float64)


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
    with ExactApplies() as refined:
        nl32c, tcg = timed(model.log_likelihood)
    launched = kern.launches - before
    info = model.cg_info
    mean, t_mean = timed(lambda: model.predict(xs_mean, compute_var=False))
    (mean_v, var), t_var = timed(lambda: model.predict(xs_var))
    phase_kron_segmented(card, name, model, nl64)
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
          "cg_fallback_iterations": info.fallback_iterations, "refined_solves": refined.solves,
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


class ExactApplies:
    """Counts the exact operator's applies in each ``ops.cg.cg_solve_refined``
    call the models make inside the ``with`` block: ``solves`` gets one
    record per call (exact applies: 1 + restarts, plus the fallback's 1 +
    its iterations; with ``return_info``, the restarts and fallback
    iterations)."""

    def __enter__(self):
        from gp_grief_tpu_torch.models import gp_kron, gp_regression, gp_ski
        from gp_grief_tpu_torch.ops import cg

        self.modules, self.plain, self.solves = (gp_kron, gp_regression, gp_ski), cg.cg_solve_refined, []

        def solve(matvec_fast, matvec_exact, b, **kw):
            calls = [0]

            def counted(v):
                calls[0] += 1
                return matvec_exact(v)

            out = self.plain(matvec_fast, counted, b, **kw)
            row = {"exact_applies": calls[0]}
            if kw.get("return_info"):
                row.update(restarts=out[1].iterations // kw["inner_iters"],
                           fallback_iterations=out[1].fallback_iterations)
            self.solves.append(row)
            return out

        for module in self.modules:
            module.cg_solve_refined = solve
        return self

    def __exit__(self, *exc):
        for module in self.modules:
            module.cg_solve_refined = self.plain
        return False


def phase_kron_segmented(card: str, name: str, model, ll64: float) -> None:
    """Phase 14b: ``log_likelihood_segmented()`` of the float32 CG model at
    full size, twice (the runs bit-identical), held to the phase's float64
    Schur log-likelihood at GRID_CG_GAP_RTOL.  Its solve runs the exact
    operator, "highest", on the route ``kron_fast.kernel_route`` picks:
    K3 at grid8x512x512_exact, the chain at grid32x5_mixed."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk
    from gp_grief_tpu_torch.ops.kron_fast import kernel_route

    route = kernel_route(model._factors(), 1, "highest", vector_dtype=model.y.dtype)
    before = {"K2": tk.kron_matvec_slab.launches, "K3": tk.kron_matvec_fused.launches}
    ll, t = timed(model.log_likelihood_segmented)
    iters = model.cg_iterations
    ll2, t2 = timed(model.log_likelihood_segmented)
    launches = {"K2": tk.kron_matvec_slab.launches - before["K2"], "K3": tk.kron_matvec_fused.launches - before["K3"]}
    gap = abs(ll - ll64) / abs(ll64)
    emit({"phase": "kron_segmented", "config": name, "M": int(model.m), "cg_segment_iters": 60,
          "cg_tol": model.cg_tol, "precond_rank": model.precond_rank, "cg_whiten": model.cg_whiten,
          "route": route, "nlml_segmented": -ll, "nlml_f64_schur": -ll64, "gap": gap, "gap_tol": GRID_CG_GAP_RTOL,
          "repeat_identical": ll2 == ll, "cg_iterations": iters, "launches_two_runs": launches,
          "s": [t, t2], "card": card})
    check(np.isfinite(ll) and gap <= GRID_CG_GAP_RTOL,
          f"{name}: segmented NLML {-ll} off the f64 schur NLML {-ll64} by {gap:.3e}")
    check(ll2 == ll, f"{name}: two segmented NLML runs differ ({-ll} vs {-ll2})")
    check(route != "fused" or launches["K3"] > 0, f"{name}: the segmented NLML's route is K3 but K3 never launched")
    check(name != "grid8x512x512_exact" or route == "fused", f"{name}: the segmented NLML's route is {route}, not K3")


# float64 on the card against the JAX package's float64 CPU run of the same
# configuration, probes and eigen-conventions (tools/ski_reference_jax.py),
# with cg_tol tightened to 1e-10 in both: rounding only.  At the
# configurations' 1e-6 two float64 runs stop their CG a step apart and their
# predictive means differ by ~1.5e-8 (tests/test_torch_slice.py's shrunk
# lattice, on the CPU); the NLML's quadratic form is second order in that.
SKI_F64_RTOL = 1e-8
# float32 NLML against the card's float64 one, same probes: float32 CG stops
# at 20·eps32 ≈ 2.4e-6 relative residual at the earliest and its SLQ rounds
# in float32; the NLML is a sum of ~1e5-1e6-sized terms.
SKI_F32_RTOL = 1e-3
# float32 predictions against the card's float64 ones at the same points,
# relative to the float64 values' largest magnitude; both stop their CG at
# tol 1e-6.  Measured on an H100 (PERF.md §6, PR 3): ski100k_data mean 1.5e-5,
# variance 3.0e-3; ski1m_lattice mean 1.7e-3, variance 1.2e-2, the same bits
# in every run on one card.  The lattice dual's float32 model clamps the
# per-dimension eigenvalues at 10·eps32·λmax (float64: 10·eps64·λmax), a
# rougher prior where the spectrum decays fastest; the JAX package's float32
# lattice shows the same mean gap as the port's (tools/ski_f32_gap_jax.py).
# Each limit is about three times the measured gap.
SKI_F32_PRED_RTOL = {"ski100k_data": {"mean": 5e-5, "var": 1e-2},
                     "ski1m_lattice": {"mean": 5e-3, "var": 4e-2}}
# K4/K5 against their plain versions, relative to the output's largest
# magnitude: the same short sums in another order, with fused multiply-adds.
SKI_KERNEL_TOL = {"float32": 1e-6, "float64": 1e-12}
# Where phases 8-9 run (a CPU rehearsal at a tiny size sets "cpu").
DEVICE = "cuda"
SKI_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "ski_reference_f64.json")

# (kernel, label, geometry, B): the shapes phase 8 holds K4/K5 to.  The
# configurations' own geometry, and one ragged d = 3 lattice.
SKI_KERNEL_SHAPES = [
    ("interp_wt", "ski100k_data", "ski100k_data", 9),  # every data-space operator apply
    ("interp_wt", "ski1m_lattice_Wty", "ski1m_lattice", 1),  # W^T y of the lattice dual
    ("interp_wt", "ragged_d3_23x17x29", "ragged", 9),
    ("wtw_stencil", "ski1m_lattice", "ski1m_lattice", 9),  # every whitened apply of the CG
    ("wtw_stencil", "ragged_d3_23x17x29", "ragged", 9),
]


def device_rows(prof) -> list:
    """``(kernel name, device ms, calls)`` of every device item of a
    ``torch.profiler`` run."""
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((ev.key, dev / 1e3, ev.count))
    return rows


def device_items(prof, top=10):
    """Device time of a ``torch.profiler`` run: the total and the ``top``
    largest kernels (device events only; the CPU-side ops that launched them
    report the same time and would count it twice)."""
    rows = device_rows(prof)
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return total, [{"name": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:top]]


class NumpyProbes:
    """``ski_probe`` draws in call order, in place of the port's
    ``ops.lanczos.rademacher`` (the probes tools/ski_reference_jax.py hands
    the JAX package)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, shape, *, dtype, device, generator):
        import torch

        z = ski_probe(self.calls, tuple(shape))
        self.calls += 1
        return torch.as_tensor(z, dtype=dtype, device=device)


def with_numpy_probes(fn):
    """Run ``fn()`` with the port's probe draw replaced by :class:`NumpyProbes`."""
    import gp_grief_tpu_torch.ops.lanczos as tlz

    draw, tlz.rademacher = tlz.rademacher, NumpyProbes()
    try:
        return fn()
    finally:
        tlz.rademacher = draw


def ski_model(name: str, x, y, xg, dtype, **overrides):
    import gp_grief_tpu_torch as gpt

    cfg = SKI_CONFIGS[name]
    kerns = [gpt.make_kernel("rbf", lengthscale=cfg["lengthscale"]) for _ in range(SKI_D)]
    return gpt.GPSKIRegression(x, y, kerns, xg, noise_var=cfg["noise_var"], dtype=dtype, device=DEVICE,
                               **dict(cfg["model"], **overrides))


def ski_geometry(which: str):
    """Points and grid of a phase-8 shape (NumPy, float32)."""
    if which in SKI_CONFIGS:
        x, _, xg = ski_data(which)
        return x, xg
    rng = np.random.default_rng(5)
    xg = [np.sort(rng.uniform(0, 1, m)).astype(np.float32) for m in (23, 17, 29)]
    return rng.uniform(-0.05, 1.05, (5000, 3)).astype(np.float32), xg


def phase_ski_kernels(card: str) -> dict:
    """K4 and K5 against their plain versions, float32 and float64, two
    launches bit-identical; CUDA-event times of the kernel, the plain version
    and one torch.sparse.mm of the same sparse matrix, beside the bound."""
    import torch
    from gp_grief_tpu_torch.ops import interp as tint
    from gp_grief_tpu_torch.ops import interp_stencil as tst
    from gp_grief_tpu_torch.ops.cuda import interp_wt, stencil as k5, wtw_stencil

    summary = {}
    for kname, label, which, B in SKI_KERNEL_SHAPES:
        x, xg = ski_geometry(which)
        iw = tint.interp_weights(x, xg)
        stream = tint.build_corner_stream(iw)
        n, M = int(x.shape[0]), int(np.prod(iw.shape))
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).replace("torch.", "")
            size = torch.empty(0, dtype=dtype).element_size()
            g = torch.Generator(device="cpu").manual_seed(0)
            with torch.no_grad():
                if kname == "interp_wt":
                    plan = tint.build_interp_plan(iw, stream=stream, dtype=dtype, device=DEVICE)
                    u = torch.randn((B, n), generator=g, dtype=torch.float64).to(DEVICE, dtype)
                    L = int(plan.src_col.shape[0])
                    crow = torch.cat([plan.start_ptr[:1], plan.end_ptr]).long()
                    lib_mat = torch.sparse_csr_tensor(crow, plan.src_col.long(), plan.w_sorted, size=(M, n))
                    lib_rhs = u.T.contiguous()
                    fn, plain = (lambda: interp_wt(plan, u)), (lambda: tint.interp_rmatvec_bm_exact(plan, u))
                    nbytes = size * (B * n + L + B * M) + 4 * (L + 2 * M)
                    ops, extra = 2.0 * L * B, {"n": n, "stream_entries": L}
                else:
                    st = tst.build_wtw_stencil(iw, stream=stream, dtype=dtype, device=DEVICE)
                    v = torch.randn((B, M), generator=g, dtype=torch.float64).to(DEVICE, dtype)
                    D = len(st.deltas)
                    cells = torch.arange(M, device=DEVICE)
                    cols = cells[None, :] + st.delta_t[:, None]
                    keep = (cols >= 0) & (cols < M) & (st.tables != 0)
                    idx = torch.stack([cells.expand(D, M)[keep], cols[keep]])
                    lib_mat = torch.sparse_coo_tensor(idx, st.tables[keep], (M, M)).coalesce().to_sparse_csr()
                    del cols, keep, idx
                    lib_rhs = v.T.contiguous()
                    fn, plain = (lambda: wtw_stencil(st, v)), (lambda: tst.stencil_apply_ref(st, v))
                    nbytes = size * (D * M + 2 * B * M) + 8 * D
                    plan = k5._cached_plan(st, B, size)[0]
                    # The other member on the same operands: the same bits.
                    other = (k5.StencilPlan("cell", k5.MAX_ROWS, -(-B // k5.MAX_ROWS)) if plan.member == "window"
                             else None)
                    other_out = k5._launch(st, v, other) if other is not None else None
                    ops, extra = 2.0 * D * B * M, {"offsets": D, "nonzeros": int(lib_mat.values().numel()),
                                                   "member": plan.member, "cells": plan.cells,
                                                   "buffers": plan.buffers}
                got = fn()
                again = fn()
                torch.cuda.synchronize()
                ref = plain()
                lib = torch.sparse.mm(lib_mat, lib_rhs).T
                scale = float(ref.abs().max())
                rel = float((got - ref).abs().max()) / scale
                abs_err = float((got - ref).abs().max())
                rel_lib = float((lib - ref).abs().max()) / scale
                identical = bool(torch.equal(got, again))
                if kname == "wtw_stencil" and other_out is not None:
                    extra["cell_member_identical"] = bool(torch.equal(got, other_out))
                    identical = identical and extra["cell_member_identical"]
                    del other_out
                finite = tuple(got.shape) == (B, M) and bool(torch.isfinite(got).all())
                ms = cuda_ms(fn)
                dev_ms = device_ms(fn)
                plain_ms = cuda_ms(plain)
                library_ms = cuda_ms(lambda: torch.sparse.mm(lib_mat, lib_rhs))
            t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_FLOPS["highest"]
            bound_ms, bound_by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
            emit({"phase": "ski_kernel", "kernel": kname, "shape": label, "grid": list(iw.shape), "M": M, "B": B,
                  "dtype": tag, **extra, "max_rel_err": rel, "max_abs_err": abs_err, "tol": SKI_KERNEL_TOL[tag],
                  "tol_reason": "relative to the output's largest magnitude", "library_rel_err": rel_lib,
                  "two_launches_identical": identical, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                  "library_ms": library_ms, "library": "torch.sparse.mm (CSR)", "bound_ms": bound_ms, "bound_by": bound_by,
                  "gb_per_s": nbytes / (ms * 1e-3) / 1e9, "card": card})
            check(finite, f"{kname} {label} {tag}: bad output")
            check(rel <= SKI_KERNEL_TOL[tag], f"{kname} {label} {tag}: rel err {rel:.3e} vs plain")
            check(identical, f"{kname} {label} {tag}: two launches (or the two members) differ")
            entry = summary.setdefault(kname, {"max_abs_err": 0.0})
            if kname == "wtw_stencil":
                entry.setdefault("members", {})[f"{label} {tag}"] = extra["member"]
            if tag == "float32":
                entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
                if label in SKI_CONFIGS:
                    entry.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
            del got, again, ref, lib, lib_mat, lib_rhs
            torch.cuda.empty_cache()
    return summary


def load_ski_reference() -> dict:
    with open(SKI_REFERENCE) as f:
        return json.load(f)


def phase_ski_f64(name: str, reference: dict) -> dict:
    """float64 runs of one SKI configuration on the card, with the JAX
    package's numpy probes.  (a) At the reference's size and CG tolerance:
    the NLML and exact predictions at its test points, held to its recorded
    values.  (b) At full size: the NLML and the predictions at the float32
    run's test points, which phase_ski holds the float32 model to."""
    import torch

    f64 = np.float64
    r = reference[name]
    x, y, xg = ski_data(name, r["n"], r["m"])
    model = ski_model(name, x.astype(f64), y.astype(f64), [g.astype(f64) for g in xg], torch.float64,
                      cg_tol=r["cg_tol"])
    nl_ref, t_nl_ref = timed(lambda: with_numpy_probes(lambda: -model.log_likelihood()))
    (mean, var), t_pred_ref = timed(lambda: model.predict(ski_test_points(name, r["points"]).astype(f64),
                                                          variance="exact", chunk=r["chunk"]))
    jm, jv = np.asarray(r["mean"]), np.asarray(r["var"])
    errs = {"nlml": abs(nl_ref - r["nlml"]) / abs(r["nlml"]),
            "mean": float(np.abs(mean.cpu().numpy() - jm).max() / np.abs(jm).max()),
            "var": float(np.abs(var.cpu().numpy() - jv).max() / np.abs(jv).max())}
    for what, err in errs.items():
        check(err <= SKI_F64_RTOL, f"{name}: f64 {what} rel err {err:.3e} vs the JAX package")
    del model
    torch.cuda.empty_cache()
    x, y, xg = ski_data(name)
    model = ski_model(name, x.astype(f64), y.astype(f64), [g.astype(f64) for g in xg], torch.float64)
    nl, t_nl = timed(lambda: with_numpy_probes(lambda: -model.log_likelihood()))
    mean, t_mean = timed(lambda: model.predict(ski_test_points(name, 10_000).astype(f64), compute_var=False))
    (_, var), t_var = timed(lambda: model.predict(ski_test_points(name, 256, seed=2).astype(f64)))
    del model
    torch.cuda.empty_cache()
    return {"reference_size": {k: r[k] for k in ("n", "m", "cg_tol", "points", "chunk")},
            "nlml_vs_jax": nl_ref, "jax_nlml": r["nlml"], "rel_err_vs_jax": errs, "nlml": nl,
            "mean": mean, "var": var,
            "s": {"nlml_ref_size": t_nl_ref, "predict_ref_size": t_pred_ref, "nlml": t_nl,
                  "predict_mean_10k": t_mean, "predict_var_256": t_var}}


def phase_ski(card: str, name: str, ref64: dict) -> dict:
    """One SKI configuration in float32 through ``GPSKIRegression`` on the
    card, held to its float64 run (``phase_ski_f64``); returns the kernel
    launches of the profiled NLML."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gp_grief_tpu_torch.ops.cuda import interp_wt, kron_matvec_fused, kron_matvec_slab, wtw_stencil

    kernels = {"K4": interp_wt, "K5": wtw_stencil, "K2": kron_matvec_slab, "K3": kron_matvec_fused}
    cfg = SKI_CONFIGS[name]

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}

    # (a) The NLML with the float64 run's probes; the first call builds the plans.
    x, y, xg = ski_data(name)
    model = ski_model(name, x, y, xg, torch.float32)
    nl32, t32_first = timed(lambda: with_numpy_probes(lambda: -model.log_likelihood()))
    nl64 = ref64["nlml"]
    gap = abs(nl32 - nl64) / abs(nl64)
    # (b) The NLML as a user calls it (the model's own probes), profiled.
    torch.cuda.synchronize()
    before = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nl_own = -model.log_likelihood()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in counts().items()}
    dev_total, items = device_items(prof)
    info = model.cg_info
    # (c) predict: the mean at 10,000 points, exact variances at 256, each
    # against the float64 model's at the same points.
    xs_var = ski_test_points(name, 256, seed=2)
    mean, t_mean = timed(lambda: model.predict(ski_test_points(name, 10_000), compute_var=False))
    (_, var), t_var = timed(lambda: model.predict(xs_var))
    mean64, var64 = ref64["mean"], ref64["var"]
    mean_err = float((mean.double() - mean64).abs().max() / mean64.abs().max())
    var_err = float((var.double() - var64).abs().max() / var64.abs().max())
    tol = SKI_F32_PRED_RTOL[name]
    out = {"phase": "ski", "config": name, "n": cfg["n"], "M": int(cfg["m"]) ** SKI_D,
           "lengthscale": cfg["lengthscale"], "noise_var": cfg["noise_var"], **cfg["model"],
           "f64_reference_size": ref64["reference_size"], "nlml_f64_vs_jax": ref64["nlml_vs_jax"],
           "jax_nlml_f64": ref64["jax_nlml"], "rel_err_vs_jax": ref64["rel_err_vs_jax"],
           "rel_tol_vs_jax": SKI_F64_RTOL, "nlml_f64": nl64, "nlml_f32": nl32, "f32_gap": gap,
           "f32_gap_tol": SKI_F32_RTOL, "mean_rel_err_vs_f64": mean_err, "mean_tol": tol["mean"],
           "var_rel_err_vs_f64": var_err, "var_tol": tol["var"],
           "nlml_f32_own_probes": nl_own, "cg_iterations": info.iterations,
           "cg_rel_residual": float(info.residual_norm[0]) / float(torch.linalg.norm(model.y.double())),
           "launches_in_nlml": launched, "nlml_wall_ms": wall * 1e3, "nlml_device_ms": dev_total,
           "idle_share": 1 - dev_total / (wall * 1e3), "device_items": items,
           "plan_build_s": dict(model.plan_seconds),
           "var_min": float(var.min()), "var_max": float(var.max()),
           "s": {**{"f64_" + k: v for k, v in ref64["s"].items()}, "f32_first_nlml": t32_first,
                 "predict_mean_10k": t_mean, "predict_var_256": t_var}}
    if cfg["model"]["solver"] == "data":
        # LOVE at rank 100 with its guard under the default policy: a tripped
        # guard warns and returns the exact route's variances.
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (_, var_love), t_love = timed(lambda: model.predict(xs_var, variance="lanczos", var_rank=100))
        tripped = any("auto-upgrading" in str(w.message) for w in caught)
        love_dev = float(((var_love - var).abs() / var.abs().max()).max())
        out.update(love_var_rank=100, love_guard_tripped=tripped, love_rel_dev_vs_exact=love_dev,
                   love_guard_message=next((str(w.message)[:160] for w in caught), None))
        out["s"]["predict_love_256"] = t_love
        check(bool(torch.isfinite(var_love).all()), f"{name}: non-finite LOVE variances")
        check(not tripped or love_dev <= 1e-6, f"{name}: the LOVE guard's exact route differs by {love_dev:.3e}")
    emit({**out, "card": card})
    check(gap <= SKI_F32_RTOL, f"{name}: f32 NLML {nl32} vs f64 {nl64} (gap {gap:.3e})")
    check(mean.shape == (10_000,) and bool(torch.isfinite(mean).all()), f"{name}: bad predictive mean")
    check(var.shape == (256,) and bool(torch.isfinite(var).all() and (var >= 0).all()), f"{name}: bad variance")
    check(mean_err <= tol["mean"], f"{name}: f32 mean off the f64 mean by {mean_err:.3e} of its scale")
    check(var_err <= tol["var"], f"{name}: f32 variance off the f64 one by {var_err:.3e} of its scale")
    check(np.isfinite(nl_own), f"{name}: non-finite NLML")
    del model
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# Kernels K6-K8 (the per-axis Kronecker passes).  No model of either package
# launches them; their path is the public entry points at the 32^5 shapes the
# JAX package's benchmark scripts measured them at, and K7 as the operator of
# a grid CG (benchmarks/exp_r2_candidates.py's use of kron_matmat_pallas).
# ---------------------------------------------------------------------------

AXES_D, AXES_M = 5, 32  # the 32^5 headline lattice (BASELINE.json, bench.py)
# The K7 CG solve at grid32x5_mixed's data and parameters against the float64
# Schur solve of the same system, relative norm error of the solution: float32
# CG stops at a relative residual of 1e-6 on κ ≈ 56.  About three times the
# first measured gap, 5.95e-7 after 46 iterations on an H100 (PERF.md §6).
K7_CG_RTOL = 1.8e-6


def axes_factors():
    """benchmarks/exp_r2_candidates.py:35-37: five 32x32 factors, standard
    normal / (2.2·√32) from numpy.random.default_rng(0), float32 on the card."""
    import torch

    rng = np.random.default_rng(0)
    return [torch.as_tensor((rng.standard_normal((AXES_M, AXES_M)) / (2.2 * np.sqrt(AXES_M))).astype(np.float32),
                            device=DEVICE) for _ in range(AXES_D)]


def axes_cases():
    """Phase 10's cases: ``(kernel, label, input shape, precisions, factor
    shapes (o, m), lead rows, B, run, plain, library, chain)``.  ``run(x,
    p)`` is the entry point, ``plain(x, fast)`` its plain version (factors
    cast to x's dtype, so a float64 x gives the float64 reference),
    ``library(x)`` one float32 PyTorch call of the same function, and
    ``chain(x)`` the port's torch.matmul chain (K7; None for K6 and K8)."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk
    from gp_grief_tpu_torch.ops.cuda import kron_axes as ka
    from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast

    Ks = axes_factors()
    rng = np.random.default_rng(1)
    rect = [torch.as_tensor((rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32), device=DEVICE)
            for s in ((96, 80), (24, 32), (40, 32))]
    W = torch.kron(torch.eye(4, device=DEVICE), Ks[-1])  # I_4 ⊗ K_32 (exp_r2_passes_today.py:66-68)
    Wr = torch.as_tensor((rng.standard_normal((64, 48)) / np.sqrt(48)).astype(np.float32), device=DEVICE)
    M = AXES_M ** AXES_D

    def like(fs, x):
        return [f.to(x.dtype) for f in fs]

    def k7(fs, B):
        shape = (int(np.prod([f.shape[1] for f in fs])),) + ((B,) if B > 1 else ())
        return ("kron_matmat_cuda", shape, ["highest"], [tuple(f.shape) for f in fs], 1, B,
                lambda x, p: ka.kron_matmat_cuda(fs, x, precision=p),
                lambda x, fast: tk.kron_chain_ref(like(fs, x), x.reshape(shape[0], -1), fast=fast).reshape(-1, *shape[1:]),
                lambda x: kron_einsum(fs, x),
                lambda x: kron_matvec_fast(fs, x, precision="highest", impl="xla"))

    def k6(Wm, N):
        return ("last_slab_pass", (N, int(Wm.shape[1])), ["highest"], [tuple(Wm.shape)], N, 1,
                lambda x, p: ka.last_slab_pass(x, Wm),
                lambda x, fast: ka.last_slab_pass_ref(x, Wm.to(x.dtype), fast=fast),
                lambda x: torch.matmul(x, Wm.mT), None)

    def k8(fs, N):
        g = len(fs)
        fn, ref = (ka.tail3_pass, ka.tail3_pass_ref) if g == 3 else (ka.tail2_pass, ka.tail2_pass_ref)
        spec = "nabc,ia,jb,kc->nijk" if g == 3 else "nab,ia,jb->nij"
        return (fn.__name__, (N,) + (AXES_M,) * g, ["highest", "default"], [tuple(f.shape) for f in fs], N, 1,
                lambda x, p: fn(x, *fs, precision=p),
                lambda x, fast: ref(x, *like(fs, x), precision="default" if fast else "highest"),
                lambda x: torch.einsum(spec, x, *fs), None)

    return [
        ("grid32x5_B1", *k7(Ks, 1)),  # exp_r2_candidates.py:34-40,80
        ("grid32x5_B8", *k7(Ks, 8)),  # the SLQ probe batch
        ("rect_96x80_24x32_40x32_B8", *k7(rect, 8)),
        ("grid32x5_slab128", *k6(W, M // int(W.shape[1]))),  # exp_r2_passes_today.py:66-68
        ("odd_N_64x48", *k6(Wr, M // 48 | 1)),  # no power-of-two row block: the JAX package's XLA fallback
        ("grid32x5_tail3", *k8(Ks[2:], M // AXES_M**3)),  # exp_r2_slab_fix.py:71-83
        ("grid32x5_tail2", *k8(Ks[3:], M // AXES_M**2)),  # exp_r2_slab_fix.py:85-99
    ]


def phase_kron_axes(card: str) -> dict:
    """K6, K7 and K8 against their plain versions (float32, and a float64 run
    of the plain version), two launches bit-identical; CUDA-event times of the
    kernel, the plain version, the library call and (K7) the chain, beside
    the bound."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import kron as tk
    from gp_grief_tpu_torch.ops.cuda import kron_axes as ka

    summary = {}
    for label, kname, shape, precisions, fshapes, lead, B, run, plain, library, chain in axes_cases():
        n_in = int(np.prod(shape))
        # Several distinct inputs, cycled, so a small one is not timed from L2.
        nv = max(1, -(-(128 << 20) // (4 * n_in)))
        g = torch.Generator(device=DEVICE).manual_seed(0)
        xs = [torch.randn(shape, generator=g, device=DEVICE) for _ in range(nv)]
        sizes, outs = [s[1] for s in fshapes], [s[0] for s in fshapes]
        plan = [(0, 0, 0)] if kname == "last_slab_pass" else tk._hopper_plan(sizes, outs, B)
        for precision in precisions:
            fast = precision == "default"
            with torch.no_grad():
                got = run(xs[0], precision)
                again = run(xs[0], precision)
                torch.cuda.synchronize()
                ref = plain(xs[0], fast)
                exact = plain(xs[0].double(), False)
                # The library call is float32 at both grades: held to float64.
                lib_rel = float(torch.linalg.norm(library(xs[0]).double().reshape(exact.shape) - exact)
                                / torch.linalg.norm(exact))
                rel = float(torch.linalg.norm((got - ref).double()) / torch.linalg.norm(ref.double()))
                rel_exact = float(torch.linalg.norm(got.double() - exact) / torch.linalg.norm(exact))
                abs_err = float((got - ref).abs().max())
                identical = bool(torch.equal(got, again))
                finite = got.shape == ref.shape and bool(torch.isfinite(got).all())
                n_out = got.numel()
                del got, again, ref, exact
                it = iter(range(1 << 30))
                ms = cuda_ms(lambda: run(xs[next(it) % nv], precision))
                dev_ms, members = device_split(lambda: run(xs[next(it) % nv], precision))
                fn = getattr(ka, kname)  # K6 has no tile pass and no exact_tile_launches
                before = getattr(fn, "exact_tile_launches", 0)
                run(xs[0], precision)
                exact_passes = getattr(fn, "exact_tile_launches", 0) - before
                plain_ms = cuda_ms(lambda: plain(xs[next(it) % nv], fast))
                lib_ms = cuda_ms(lambda: library(xs[next(it) % nv]))
                chain_ms = cuda_ms(lambda: chain(xs[next(it) % nv])) if chain else None
            bound_ms, bound_by = kron_bound(sizes, B, precision, outs=outs, lead=lead)
            chained = {"chain_ms": chain_ms} if chain else {}
            emit({"phase": "kron_axes", "kernel": kname, "shape": label, "input": list(shape), "factors": fshapes,
                  "precision": precision, "passes": len(plan), "rel_err_vs_plain": rel, "tol": KRON_TOL[precision],
                  "rel_err_vs_f64": rel_exact, "f64_tol": 2e-2 if fast else 1e-5, "max_abs_err": abs_err,
                  "two_launches_identical": identical, "ms": ms, "device_ms": dev_ms, "members": members,
                  "exact_tile_passes": exact_passes, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "library_rel_err_vs_f64": lib_rel, **chained, "bound_ms": bound_ms, "bound_by": bound_by,
                  "gb_per_s": 4 * (n_in + n_out) / (ms * 1e-3) / 1e9, "distinct_inputs": nv, "card": card})
            check(finite, f"{kname} {label} {precision}: bad output")
            check(rel <= KRON_TOL[precision], f"{kname} {label} {precision}: rel err {rel:.3e} vs plain")
            check(rel_exact <= (2e-2 if fast else 1e-5), f"{kname} {label} {precision}: rel err {rel_exact:.3e} vs f64")
            check(identical, f"{kname} {label} {precision}: two launches differ")
            check(lib_rel <= 1e-5, f"{kname} {label}: the library call is off float64 by {lib_rel:.3e}")
            entry = summary.setdefault(kname, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], abs_err)
            # The line's times: each kernel's first 32^5 case at the exact grade.
            if precision == "highest" and "ms" not in entry:
                entry.update({"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "shape": label, "library_ms": lib_ms, **chained})
        del xs
        torch.cuda.empty_cache()
    return summary


def phase_kron_axes_path(card: str) -> None:
    """The slice's path: K7 as the operator of a float32 CG solve at
    grid32x5_mixed's data and parameters, held to the float64 Schur solve of
    the same system; then each K6-K8 entry point once at each phase-10 shape."""
    import torch
    from gp_grief_tpu_torch.ops.cg import cg_solve
    from gp_grief_tpu_torch.ops.cuda import kron as tk
    from gp_grief_tpu_torch.ops.cuda import kron_axes as ka
    from gp_grief_tpu_torch.ops.kron import kron_eigh, kron_solve_schur

    name = "grid32x5_mixed"
    cfg = GRID_CONFIGS[name]
    xg, y = grid_data(name)
    with torch.no_grad():
        m32 = grid_model(name, xg, y, torch.float32, DEVICE)
        Ks = [K.contiguous() for K in m32._factors()]
        s2 = float(torch.exp(m32.log_noise))
        before = ka.kron_matmat_cuda.launches
        (x32, info), t_cg = timed(lambda: cg_solve(lambda v: ka.kron_matvec_cuda(Ks, v) + s2 * v, m32.y,
                                                   tol=cfg["model"]["cg_tol"], max_iters=cfg["model"]["cg_iters"],
                                                   return_info=True))
        launched = ka.kron_matmat_cuda.launches - before
        del m32
        m64 = grid_model(name, xg, y, torch.float64, DEVICE)
        K64 = m64._factors()
        s64 = float(torch.exp(m64.log_noise))
        Qs, lams = kron_eigh(K64)
        x64, t_schur = timed(lambda: kron_solve_schur(Qs, lams, m64.y, shift=s64))
        rel = float(torch.linalg.norm(x32.double() - x64) / torch.linalg.norm(x64))
        resid = tk.kron_chain_ref(K64, x32.double()[:, None])[:, 0] + s64 * x32.double() - m64.y
        rel_res = float(torch.linalg.norm(resid) / torch.linalg.norm(m64.y))
        finite = bool(torch.isfinite(x32).all())
        del m64, K64, Qs, x64, resid, x32
        torch.cuda.empty_cache()
    emit({"phase": "kron_axes_cg", "config": name, "M": int(np.prod(cfg["sizes"])), "noise_var": cfg["noise_var"],
          "cg_tol": cfg["model"]["cg_tol"], "cg_iterations": info.iterations, "k7_launches": launched,
          "rel_err_vs_f64_schur": rel, "tol": K7_CG_RTOL, "true_rel_residual_f64": rel_res,
          "s": {"cg_f32": t_cg, "schur_f64": t_schur}, "card": card})
    check(finite, f"{name}: non-finite K7 CG solution")
    check(launched > 0, "the K7 CG solve never launched kron_matmat_cuda")
    check(rel <= K7_CG_RTOL, f"{name}: K7 CG solution off the f64 Schur solution by {rel:.3e}")
    # Each entry point once at its phase-10 shapes, as a caller runs it.
    with torch.no_grad():
        for label, kname, shape, precisions, fshapes, lead, B, run, *_ in axes_cases():
            x = torch.randn(shape, generator=torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE)
            for precision in precisions:
                out = run(x, precision)
                check(bool(torch.isfinite(out).all()), f"{kname} {label} {precision}: non-finite output")
            del x, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Training through the iterative solvers: the grid model's CG implicit
# gradient and SKI's BBMM surrogates.
# ---------------------------------------------------------------------------

# 5 Adam steps of each grid configuration, as a user calls them.
GRID_TRAIN = dict(optimizer="adam", max_iters=5, learning_rate=0.05)
# The float32 NLML gradient through the CG implicit gradient against the same
# model's float64 schur gradient on the card, max abs difference relative to
# the largest component.  About three times the measured gap (PERF.md §6,
# PR 9).
# Measured 9.59e-8 and 1.56e-5 on an H100 (chip_smoke's first run, PR 9).
GRID_GRAD_RTOL = {"grid32x5_mixed": 3e-7, "grid8x512x512_exact": 5e-5}
# benchmarks/exp_r11_train_mixed.py's recipe at ski1m_lattice (its step
# solves in float32, then in bf16 from the same start); 5 steps at
# ski100k_data.
SKI_TRAIN = {"ski1m_lattice": dict(max_iters=8, learning_rate=0.05, num_probes=8),
             "ski100k_data": dict(max_iters=5, learning_rate=0.05, num_probes=8)}
# The float64 NLML gradient on the card against the JAX package's float64
# CPU run at tools/ski_reference_f64.json's sizes, same probes, cg_tol 1e-10:
# rounding only (the CPU tests measure ≤ 3.8e-12 at n = 400).
SKI_TRAIN_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                   "ski_train_reference_f64.json")
SKI_GRAD_F64_RTOL = 1e-8
# log_likelihood_segmented (probe chunks of 4) against log_likelihood at
# ski1m_lattice, relative: other probes, so the SLQ sampling error of 8
# probes.  About three times the measured gap, 2.03e-6 on an H100 (PERF.md
# §6, PR 9); the probes are seeded, so the gap is the same on every run.
SKI_SEGMENTED_RTOL = 6e-6


class StepStats:
    """Per-step figures of a training run, fed by the training loop's
    callback: host wall between the ends of consecutive steps (each read after
    a synchronize), peak device memory and kernel launches of each step; with
    ``profiled``, one ``torch.profiler`` run over all steps, whose kernels
    are given to the step in whose window they start (a marker is recorded
    at each step's end): device time and idle share per step."""

    MARK = "chip_smoke.step_end"

    def __init__(self, kernels: dict, profiled: bool):
        self.kernels, self.profiled, self.rows = kernels, profiled, []

    def _counts(self):
        return {k: fn.launches for k, fn in self.kernels.items()}

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = None
        if self.profiled:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.before, self.t = self._counts(), time.perf_counter()
        return self

    def step(self, **extra):
        import torch

        torch.cuda.synchronize()
        now, counts = time.perf_counter(), self._counts()
        if self.prof is not None:
            with torch.profiler.record_function(self.MARK):
                pass
        self.rows.append({"wall_ms": (now - self.t) * 1e3, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "launches": {k: counts[k] - self.before[k] for k in counts}, **extra})
        torch.cuda.reset_peak_memory_stats()
        self.before, self.t = counts, time.perf_counter()

    def __exit__(self, *exc):
        if self.prof is None:
            return False
        self.prof.__exit__(*exc)
        events = self.prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == self.MARK)
        dev = [0.0] * len(self.rows)
        for e in events:
            if not str(e.device_type).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            i = int(np.searchsorted(marks, e.time_range.start))
            if i < len(dev):
                dev[i] += us / 1e3
        for row, d in zip(self.rows, dev):
            row.update(device_ms=d, idle_share=1 - d / row["wall_ms"])
        self.device_total_ms, items = device_items(self.prof, top=60)
        self.device_by_kind_ms = kernel_groups(items)
        return False


def merged_steps(plain: list, profiled: list) -> list:
    """One row per step: the unprofiled run's figures, with the profiled
    run's wall, device time and idle share beside them."""
    return [dict(u, wall_ms_profiled=r["wall_ms"], device_ms=r["device_ms"], idle_share=r["idle_share"])
            for u, r in zip(plain, profiled)]


def flat_grad(model, loss_fn):
    """The model's loss and its gradient, flat in the JAX package's leaf order."""
    import torch

    model.zero_grad()
    loss = loss_fn()
    loss.backward()
    return float(loss.detach()), torch.cat([p.grad.reshape(-1).double() for _, p in model._leaves()])


def same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def schur_loss_f64(model):
    """A float64 grid model's NLML, differentiable, with the quadratic form's
    solve in closed form: ``2yᵀα − αᵀAα`` with ``α = A⁻¹y`` by the Schur
    solve held fixed, whose gradient ``−αᵀ(dA)α`` is the exact one at ``α``,
    and ``log|A|`` through the eigenvalues alone.  Differentiating the Schur
    form itself would run the eigenvectors' derivative, which divides by the
    factors' eigenvalue gaps (2.5e-12 at grid32x5_mixed; round-off-degenerate
    at 512 points): it gives NaN there."""
    import torch
    from gp_grief_tpu_torch.ops.kron import kron_solve_schur, lam_kron
    from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast

    sigma2 = torch.exp(model.log_noise)
    factors = model._factors()
    Qs, lams = model._eig(factors)
    with torch.no_grad():
        alpha = kron_solve_schur(Qs, lams, model.y, sigma2)
    Aalpha = kron_matvec_fast(tuple(K.contiguous() for K in factors), alpha, precision="highest") + sigma2 * alpha
    quad = 2.0 * torch.dot(model.y, alpha) - torch.dot(alpha, Aalpha)
    logdet = torch.sum(torch.log(lam_kron(lams) + sigma2))
    return 0.5 * (quad + logdet + model.m * np.log(2.0 * np.pi))


def phase_grid_train(card: str, name: str) -> None:
    """One grid configuration trained through CG: the float32 NLML gradient
    (the CG implicit gradient) against the float64 gradient with the Schur
    solve (:func:`schur_loss_f64`) on the card, then GRID_TRAIN's Adam steps twice from the same start (the second
    run profiled per step): the same bits both times and a lower NLML."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import kron_matvec_fused, kron_matvec_slab

    kernels = {"K2": kron_matvec_slab, "K3": kron_matvec_fused}
    xg, y = grid_data(name)
    m64 = grid_model(name, xg, y, torch.float64, DEVICE, solver="schur")
    (_, g64), t64 = timed(lambda: flat_grad(m64, lambda: schur_loss_f64(m64)))
    del m64
    torch.cuda.empty_cache()
    model = grid_model(name, xg, y, torch.float32, DEVICE)
    before = {k: fn.launches for k, fn in kernels.items()}
    torch.cuda.reset_peak_memory_stats()
    (_, g32), t32 = timed(lambda: flat_grad(model, model._loss))
    grad_peak = torch.cuda.max_memory_allocated() / 1e9
    grad_launches = {k: fn.launches - before[k] for k, fn in kernels.items()}
    gap = float((g32 - g64).abs().max() / g64.abs().max())
    start = [p.detach().clone() for _, p in model._leaves()]
    ll0, t_value = timed(model.log_likelihood)  # the forward solve alone
    runs = []
    for profiled in (False, True):
        with torch.no_grad():
            for (_, p), v in zip(model._leaves(), start):
                p.copy_(v)
        with StepStats(kernels, profiled) as stats:
            res = model.optimize(callback=lambda it, value, gnorm: stats.step(loss=value, grad_norm=gnorm),
                                 **GRID_TRAIN)
        runs.append((res, [p.detach().clone() for _, p in model._leaves()], stats))
    ll1 = model.log_likelihood()
    (r0, p0, st0), (r1, p1, st1) = runs
    identical = np.array_equal(r0.losses, r1.losses) and same_bits(p0, p1)
    emit({"phase": "grid_train", "config": name, "M": int(np.prod(GRID_CONFIGS[name]["sizes"])),
          **GRID_CONFIGS[name]["model"], **GRID_TRAIN, "grad_f32_cg": g32.tolist(), "grad_f64_schur": g64.tolist(),
          "grad_gap": gap, "grad_gap_tol": GRID_GRAD_RTOL[name], "grad_launches": grad_launches,
          "grad_peak_gb": grad_peak, "nlml_before": -ll0, "nlml_after": -ll1, "losses": r0.losses.tolist(),
          "runs_identical": identical, "cg_iterations_last": model.cg_info.iterations,
          "steps": merged_steps(st0.rows, st1.rows), "device_ms_profiled_run": st1.device_total_ms,
          "device_by_kind_ms_profiled_run": st1.device_by_kind_ms,
          "s": {"grad_f64_schur": t64, "grad_f32_cg": t32, "nlml_f32_cg": t_value, "train_unprofiled": r0.wall_time,
                "train_profiled": r1.wall_time}, "card": card})
    check(bool(torch.isfinite(g32).all()), f"{name}: non-finite CG gradient")
    check(gap <= GRID_GRAD_RTOL[name], f"{name}: f32 CG gradient off the f64 schur gradient by {gap:.3e}")
    check(identical, f"{name}: two training runs from the same start differ")
    check(ll1 > ll0, f"{name}: the NLML rose in training ({-ll0} -> {-ll1})")
    check(sum(grad_launches.values()) > 0, f"{name}: the CG gradient never launched K2/K3")
    del model
    torch.cuda.empty_cache()


def phase_ski_grad_f64(name: str) -> dict:
    """The float64 NLML gradient (BBMM surrogate) of one SKI configuration
    on the card at the JAX reference's size and probes, against
    tools/ski_train_reference_f64.json."""
    import torch

    r = json.load(open(SKI_TRAIN_REFERENCE))[name]
    f64 = np.float64
    x, y, xg = ski_data(name, r["n"], r["m"])
    model = ski_model(name, x.astype(f64), y.astype(f64), [g.astype(f64) for g in xg], torch.float64,
                      cg_tol=r["cg_tol"])
    check([k for k, _ in model._leaves()] == r["leaves"], f"{name}: parameter order differs from the reference")
    from gp_grief_tpu_torch.ops.cuda import interp_wt

    def grad_and_adjoint():
        model.zero_grad()
        loss = model._loss()
        before = interp_wt.launches
        loss.backward()  # the data solver's W adjoint is K4
        grad = torch.cat([p.grad.reshape(-1).double() for _, p in model._leaves()])
        return float(loss.detach()), grad, interp_wt.launches - before

    (nlml, grad, adjoint), t = timed(lambda: with_numpy_probes(grad_and_adjoint))
    if model.solver == "data":
        check(adjoint > 0, f"{name}: the float64 gradient's W adjoint never launched K4")
    want = torch.as_tensor(r["grad"], dtype=torch.float64)
    err = float((grad.cpu() - want).abs().max() / want.abs().max())
    nl_err = abs(nlml - r["nlml"]) / abs(r["nlml"])
    del model
    torch.cuda.empty_cache()
    check(err <= SKI_GRAD_F64_RTOL and nl_err <= SKI_GRAD_F64_RTOL,
          f"{name}: f64 gradient rel err {err:.3e} (NLML {nl_err:.3e}) vs the JAX package")
    return {"size": {k: r[k] for k in ("n", "m", "cg_tol")}, "grad": grad.tolist(), "jax_grad": r["grad"],
            "k4_launches_in_backward": adjoint, "grad_rel_err": err, "nlml_rel_err": nl_err, "tol": SKI_GRAD_F64_RTOL, "s": t}


def phase_ski_train(card: str, name: str) -> None:
    """One SKI configuration trained by ``optimize_segmented`` in float32 at
    full size (SKI_TRAIN), each variant twice from the same start (the second
    run profiled per step): the same bits both times and a lower NLML
    (``log_likelihood``, the model's own probes).  ski1m_lattice runs its step
    solves in float32 and then in bf16 (``train_mixed16``), and its
    ``log_likelihood_segmented`` against ``log_likelihood``."""
    import torch
    from gp_grief_tpu_torch.ops.cuda import interp_wt, kron_matvec_fused, kron_matvec_slab, wtw_stencil

    kernels = {"K2": kron_matvec_slab, "K3": kron_matvec_fused, "K4": interp_wt, "K5": wtw_stencil}
    f64 = phase_ski_grad_f64(name)
    x, y, xg = ski_data(name)
    model = ski_model(name, x, y, xg, torch.float32)
    lattice = model.solver == "lattice"
    ll0 = model.log_likelihood()
    start = [p.detach().clone() for _, p in model._leaves()]
    out = {"phase": "ski_train", "config": name, "n": SKI_CONFIGS[name]["n"], "M": model.M, **SKI_CONFIGS[name]["model"],
           **SKI_TRAIN[name], "f64_grad": f64, "nlml_before": -ll0, "variants": {}}
    for mixed in ((False, True) if lattice else (False,)):
        model._train_mixed16 = mixed
        runs = []
        for profiled in (False, True):
            with torch.no_grad():
                for (_, p), v in zip(model._leaves(), start):
                    p.copy_(v)
            with StepStats(kernels, profiled) as stats:
                res = model.optimize_segmented(callback=lambda it, value, info: stats.step(surrogate=value, **info),
                                               **SKI_TRAIN[name])
            runs.append((res, [p.detach().clone() for _, p in model._leaves()], stats))
        (r0, p0, st0), (r1, p1, st1) = runs
        rows0 = st0.rows
        ll1 = model.log_likelihood()
        identical = np.array_equal(r0.losses, r1.losses) and same_bits(p0, p1)
        out["variants"]["mixed16" if mixed else "float32"] = {
            "nlml_after": -ll1, "surrogate": r0.losses.tolist(), "runs_identical": identical,
            "params_after": torch.cat([p.reshape(-1) for p in p0]).tolist(),
            "steps": merged_steps(rows0, st1.rows), "device_ms_profiled_run": st1.device_total_ms,
            "device_by_kind_ms_profiled_run": st1.device_by_kind_ms,
            "s": {"train_unprofiled": r0.wall_time, "train_profiled": r1.wall_time}}
        check(identical, f"{name} (train_mixed16={mixed}): two training runs from the same start differ")
        check(ll1 > ll0, f"{name} (train_mixed16={mixed}): the NLML rose in training ({-ll0} -> {-ll1})")
        check(all(r["launches"]["K4"] > 0 for r in rows0), f"{name}: a training step never launched K4")
        if lattice:
            check(all(r["launches"]["K5"] > 0 and r["launches"]["K2"] > 0 for r in rows0),
                  f"{name}: a training step never launched K5 or K2")
    if lattice:
        ll, t_ll = timed(model.log_likelihood)
        ll_seg, t_seg = timed(lambda: model.log_likelihood_segmented(probe_chunk=4))
        gap = abs(ll_seg - ll) / abs(ll)
        out.update(nlml=-ll, nlml_segmented=-ll_seg, segmented_gap=gap, segmented_gap_tol=SKI_SEGMENTED_RTOL,
                   segmented_cg_iterations=model.cg_iterations, s={"nlml": t_ll, "nlml_segmented": t_seg})
        check(gap <= SKI_SEGMENTED_RTOL, f"{name}: log_likelihood_segmented off log_likelihood by {gap:.3e}")
    emit({**out, "card": card})
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 13: GPRegression's iterative path (no kernel of the port: the Gram
# slabs and their contraction are PyTorch ops).
# ---------------------------------------------------------------------------

# benchmarks/exp_r15_train500k.py's recipe: x ~ U[0, 8]², y = sin x₀ ·
# cos 0.7x₁ + 0.1ε, RBF (ARD) lengthscale 0.8, noise 0.3, rank-128
# pivoted-Cholesky whitening, 8 probes, 24 Lanczos steps, cg_tol 1e-5, 200
# iterations; its NLML in CG segments of 8 with one probe chunk of 8, its
# training steps at lr 0.05 with probe-gradient chunks of 4.
GP_ITER = dict(precond_rank=128, num_probes=8, lanczos_iters=24, cg_tol=1e-5, cg_iters=200)
GP_ITER_NLML = dict(cg_segment_iters=8, probe_chunk=8)
GP_ITER_TRAIN = dict(learning_rate=0.05, cg_segment_iters=8, probe_grad_chunk=4)
# gp40k_matfree: the recipe at benchmarks/RESULTS_r14.md §2's n and chunk,
# against the float64 Cholesky model on the card; gp500k_matfree: the recipe
# at full size (matvec_chunk "auto": 536 rows).
GP_ITER_CONFIGS = {"gp40k_matfree": dict(n=40_000, matvec_chunk=2048),
                   "gp500k_matfree": dict(n=500_000, matvec_chunk="auto")}
GP40K_TRAIN = dict(optimizer="adam", max_iters=5, learning_rate=0.05)
GP40K_SEGMENTED_STEPS = 3
GP40K_MEAN_POINTS, GP40K_VAR_POINTS = 1024, 256
# gp500k_matfree's cuts (PERF.md §4), from tools/gp_iter_probe.py on an
# H100: an apply at n = 500k takes 7.66 s and the recipe's NLML 476.9 s (64
# CG iterations), over phase 13's 300 s, so the NLML runs at 262,144 (an
# apply 2.04 s); an optimize_segmented step took 120.3 s at 262,144, over
# the 60 s a step may take here (~450 s at 500k by the same count of
# applies), so the step runs at 131,072 (26.3 s).
GP500K_NLML_N = 262_144
GP_ITER_TRAIN_N, GP_ITER_TRAIN_STEPS = 131_072, 1
GP_ITER_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                 "gp_iterative_reference_f64.json")
# The card's float64 run against the JAX package's at the reference's size,
# same probes, cg_tol 1e-10: rounding only.
GP_ITER_F64_RTOL = 1e-8
# gp40k's float32 figures against the float64 Cholesky model, relative (the
# gradient, means and variances to their largest entry).  About three times
# the gaps measured on an H100 (PERF.md §2): the segmented NLMLs 9.90e-5 and
# 9.91e-5, the loss 2.70e-4, the gradient 6.12e-4, the means 4.58e-5, the
# variances 2.36e-3.  The probes are seeded, so each gap repeats run to run.
GP40K_RTOL = {"nlml_fused": 3e-4, "nlml_separate": 3e-4, "loss": 8e-4, "grad": 2e-3, "mean": 1.5e-4, "var": 7e-3}
# mixed16 against plain, relative (the JAX package's test).
GP_MIXED16_RTOL = 1e-3
# One float32 apply at n = 500k against float64 rows, relative to the
# largest: three times the 1.61e-6 measured on an H100 (PERF.md §2).
GP500K_APPLY_RTOL = 5e-6


def gp_iter_data(n: int, seed: int = 0):
    """The recipe's data (float32), drawn as the JAX script draws it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 8, size=(n, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def gp_iter_test_points(count: int, seed: int = 1):
    return np.random.default_rng(seed).uniform(0, 8, size=(count, 2)).astype(np.float32)


def gp_iter_model(x, y, dtype, device, **overrides):
    import gp_grief_tpu_torch as gpt

    kern = gpt.make_kernel("rbf", lengthscale=0.8, input_dim=2, dtype=dtype, device=device)
    return gpt.GPRegression(x, y, kern, noise_var=0.3, solver="iterative", dtype=dtype, device=device,
                            **{**GP_ITER, **overrides})


def gram_apply_bound_ms(n: int, B: int, d: int = 2) -> float:
    """The least time one apply of the matrix-free Gram could take: n² entries,
    each 2d flops of distance, ~8 more (scale, clamp, snap, the exp as one,
    the variance) and 2B of contraction, at the FP32 rate (TF32 is off).
    Its bytes (x, vv and the output, once each) are under 0.1% of that."""
    return n * n * (2 * d + 8 + 2 * B) / H100_FLOPS["fp32"] * 1e3


class BusySampler:
    """The card's busy share over a run, from NVML: ``nvidia-smi`` samples
    ``utilization.gpu`` (the share of each sample period in which a kernel
    ran) every 100 ms while the ``with`` block runs.  ``torch.profiler``'s
    post-processing costs about 0.65 ms per kernel on the card's host, and a
    gp40k Adam step launches ~23,000 (PERF.md §6), so phase 13 takes
    device time this way; ``busy`` is None if no sample came."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits", "-i", "0", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        vals = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
        self.busy = float(np.mean(vals)) / 100.0 if vals else None
        self.samples = len(vals)
        return False


def run_measured(fn):
    """``fn()`` once: its result, wall (s), peak memory (GB), and the card's
    busy share (:class:`BusySampler`) with the device time and idle share it
    gives."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with BusySampler() as busy:
        out, wall = timed(fn)
    stats = {"wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "nvml_samples": busy.samples}
    if busy.busy is not None:
        stats.update(device_s=busy.busy * wall, idle_share=1.0 - busy.busy)
    return out, stats


def rel_err(got, want) -> float:
    import torch

    # Lists go through NumPy: torch.as_tensor would make them float32.
    got, want = (t.detach().double().cpu() if isinstance(t, torch.Tensor)
                 else torch.as_tensor(np.asarray(t, dtype=np.float64)) for t in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def chol_exact(model, x_star=None, n_var: int = 0, grad: bool = False, block: int = 2048) -> dict:
    """A float64 ``GPRegression``'s exact answer on the card from one Cholesky
    factor of its ``(n, n)`` Gram, built in row blocks: the NLML; with
    ``grad``, its gradient ``½ tr((K̃⁻¹ − ααᵀ) ∂K̃/∂θ)`` in the flat leaf order,
    summed over row blocks of ``K̃⁻¹`` from ``cholesky_inverse`` (autograd
    through the factor would keep several more n² buffers); with ``x_star``,
    the predictive means there and the variances at its first ``n_var``
    points."""
    import torch
    from gp_grief_tpu_torch.models.gp_regression import _cov_any

    x, y, kern = model.x, model.y, model.kernel
    n = x.shape[0]
    out = {}
    with torch.no_grad():
        sigma2 = torch.exp(model.log_noise)
        K = torch.empty((n, n), dtype=x.dtype, device=x.device)
        for s in range(0, n, block):
            K[s : s + block] = _cov_any(kern, x[s : s + block], x)
        K.diagonal().add_(sigma2)
        L = torch.linalg.cholesky(K)
        del K
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        out["nlml"] = float(0.5 * (torch.dot(y, alpha) + 2.0 * torch.log(torch.diagonal(L)).sum()
                                   + n * np.log(2.0 * np.pi)))
        if x_star is not None:
            xs = torch.as_tensor(x_star, dtype=x.dtype, device=x.device)
            Ks = _cov_any(kern, xs, x)
            out["mean"] = (Ks @ alpha).cpu()
            A = torch.linalg.solve_triangular(L, Ks[:n_var].T, upper=False)
            prior = torch.exp(kern.log_variance)
            out["var"] = torch.clamp_min(prior - torch.sum(A * A, dim=0), 0.0).cpu()
            del Ks, A
        if grad:
            W = torch.cholesky_inverse(L)
            del L
            W.addr_(alpha, alpha, alpha=-1.0)  # K̃⁻¹ − ααᵀ
            trace_w = float(torch.diagonal(W).sum())
    if grad:
        model.zero_grad()
        for s in range(0, n, block):
            (0.5 * torch.sum(W[s : s + block] * _cov_any(kern, x[s : s + block], x))).backward()
        with torch.no_grad():
            model.log_noise.grad = 0.5 * sigma2 * trace_w  # ∂K̃/∂log σ² = σ²I
        out["grad"] = torch.cat([p.grad.reshape(-1).double() for _, p in model._leaves()]).cpu()
        del W
    torch.cuda.empty_cache()
    return out


def phase_gp_iter_f64(reference: dict) -> dict:
    """The card's float64 run of the recipe at tools/gp_iterative_reference_f64.json's
    size, with the JAX package's NumPy probes in the same call order: the
    segmented NLML, ``_loss`` and its gradient, one ``optimize_segmented``
    step, then predictions; each held to the JAX package's value."""
    import torch

    r = reference
    x, y = gp_iter_data(r["n"])
    model = gp_iter_model(x.astype(np.float64), y.astype(np.float64), torch.float64, DEVICE,
                          matvec_chunk=r["matvec_chunk"], cg_tol=r["cg_tol"], cg_iters=r["cg_iters"])
    check(model._param_leaf_names() == r["leaves"], "gp_iter f64: parameter order differs from the reference")
    xs = gp_iter_test_points(r["test_points"]).astype(np.float64)

    def run():
        nlml_seg = -model.log_likelihood_iterative_segmented(**GP_ITER_NLML)
        loss, grad = flat_grad(model, model._loss)
        model.optimize_segmented(max_iters=1, **GP_ITER_TRAIN)
        mean, var = model.predict(xs)
        return nlml_seg, loss, grad, model.parameters, mean, var

    (nlml_seg, loss, grad, params, mean, var), t = timed(lambda: with_numpy_probes(run))
    errs = {"nlml_segmented": abs(nlml_seg - r["nlml_segmented"]) / abs(r["nlml_segmented"]),
            "loss": abs(loss - r["loss"]) / abs(r["loss"]), "grad": rel_err(grad, r["grad"]),
            "params_after_step": rel_err(params, r["params_after_step"]), "mean": rel_err(mean, r["mean"]),
            "var": rel_err(var, r["var"])}
    del model
    torch.cuda.empty_cache()
    check(max(errs.values()) <= GP_ITER_F64_RTOL, f"gp_iter f64 vs the JAX package: {errs}")
    return {"size": {k: r[k] for k in ("n", "matvec_chunk", "cg_tol", "cg_iters")}, "rel_err": errs,
            "tol": GP_ITER_F64_RTOL, "s": t}


def train_twice(model, start, run):
    """``run(stats)`` from the same start twice, the second run measured
    (:func:`run_measured`): the first run's result, whether the two agree
    bit for bit, the per-step rows and the second run's figures."""
    import torch

    runs = []
    for _ in range(2):
        with torch.no_grad():
            for (_, p), v in zip(model._leaves(), start):
                p.copy_(v)
        with StepStats({}, False) as stats:
            res, measured = run_measured(lambda: run(stats))
        runs.append((res, [p.detach().clone() for _, p in model._leaves()], stats.rows, measured))
    (r0, p0, rows, _), (r1, p1, _, measured) = runs
    measured.pop("peak_gb")  # StepStats resets the peak each step: the rows carry it
    return r0, np.array_equal(r0.losses, r1.losses) and same_bits(p0, p1), rows, measured


def phase_gp40k(card: str) -> dict:
    """gp40k_matfree: the recipe at n = 40,000, float32 and matrix-free,
    against the float64 Cholesky model on the card (a 12.8 GB Gram)."""
    import torch

    cfg = GP_ITER_CONFIGS["gp40k_matfree"]
    n, chunk = cfg["n"], cfg["matvec_chunk"]
    x, y = gp_iter_data(n)
    xs = gp_iter_test_points(GP40K_MEAN_POINTS)
    m64 = gp_iter_model(x, y, torch.float64, DEVICE, matvec_chunk=chunk)
    exact, t_exact = timed(lambda: chol_exact(m64, xs, GP40K_VAR_POINTS, grad=True))
    model = gp_iter_model(x, y, torch.float32, DEVICE, matvec_chunk=chunk)
    start = [p.detach().clone() for _, p in model._leaves()]
    out = {"phase": "gp_iter", "config": "gp40k_matfree", "n": n, "matvec_chunk": chunk, **GP_ITER,
           "nlml_chol_f64": exact["nlml"], "s_chol_f64_with_grad": t_exact}

    nl_fused, st = run_measured(lambda: -model.log_likelihood_iterative_segmented(**GP_ITER_NLML))
    out["nlml_fused"] = {"nlml": nl_fused, "cg_iterations": model.cg_iterations, **st}
    nl_sep, st = run_measured(lambda: -model.log_likelihood_iterative_segmented(fuse_probes=False, **GP_ITER_NLML))
    out["nlml_separate"] = {"nlml": nl_sep, "cg_iterations": model.cg_iterations, **st}
    (loss, grad), st = run_measured(lambda: flat_grad(model, model._loss))
    out["loss_and_grad"] = {"loss": loss, "grad": grad.tolist(), "grad_f64": exact["grad"].tolist(), **st}
    (mean, (mean_v, var)), st = run_measured(
        lambda: (model.predict(xs, compute_var=False), model.predict(xs[:GP40K_VAR_POINTS])))
    out["predict"] = {"mean_points": GP40K_MEAN_POINTS, "var_points": GP40K_VAR_POINTS, **st}
    with torch.no_grad():
        vv = torch.randn((1 + GP_ITER["num_probes"], n), device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(2))
        mv, mv_fast = model._gram_op(chunk), model._gram_op(chunk, "default")
        out["apply"] = {"B": vv.shape[0], "device_ms": device_ms(lambda: mv(vv), reps=3, warmup=1),
                        "ms": cuda_ms(lambda: mv(vv), reps=5, warmup=1),
                        "ms_default_precision": cuda_ms(lambda: mv_fast(vv), reps=5, warmup=1),
                        "bound_ms": gram_apply_bound_ms(n, vv.shape[0]), "bound_by": "operations"}
        del vv, mv, mv_fast

    m16 = gp_iter_model(x, y, torch.float32, DEVICE, matvec_chunk=chunk, mixed16=True)
    with ExactApplies() as refined:
        nl16, st = run_measured(lambda: -m16.log_likelihood_iterative_segmented(**GP_ITER_NLML))
    out["mixed16"] = {"nlml": nl16, "cg_iterations": m16.cg_iterations, "refined_solves": refined.solves, **st}
    del m16

    gaps = {"nlml_fused": abs(nl_fused - exact["nlml"]) / abs(exact["nlml"]),
            "nlml_separate": abs(nl_sep - exact["nlml"]) / abs(exact["nlml"]),
            "loss": abs(loss - exact["nlml"]) / abs(exact["nlml"]), "grad": rel_err(grad, exact["grad"]),
            "mean": rel_err(mean, exact["mean"]), "mean_at_var_points": rel_err(mean_v, exact["mean"][:GP40K_VAR_POINTS]),
            "var": rel_err(var, exact["var"])}
    mixed_gap = abs(nl16 - nl_fused) / abs(nl_fused)
    out.update(gaps_to_chol_f64=gaps, gap_tol=GP40K_RTOL, mixed16_gap=mixed_gap, mixed16_tol=GP_MIXED16_RTOL)

    # Training: 5 Adam steps of optimize (the monolithic BBMM loss), then 3 of
    # optimize_segmented, each twice from the same start, the Cholesky NLML
    # lower after.
    def after(params):
        with torch.no_grad():
            for (_, p), v in zip(m64._leaves(), params):
                p.copy_(v.double())
        return chol_exact(m64)["nlml"]

    r, identical, steps, st = train_twice(
        model, start, lambda stats: model.optimize(
            callback=lambda it, value, gnorm: stats.step(loss=value, grad_norm=gnorm), **GP40K_TRAIN))
    out["optimize"] = {**GP40K_TRAIN, "losses": r.losses.tolist(), "runs_identical": identical,
                       "nlml_chol_f64_after": after([p.detach() for _, p in model._leaves()]), "steps": steps,
                       "second_run": st}
    r, identical_s, steps, st = train_twice(
        model, start, lambda stats: model.optimize_segmented(
            max_iters=GP40K_SEGMENTED_STEPS, callback=lambda it, value, info: stats.step(surrogate=value, **info),
            **GP_ITER_TRAIN))
    out["optimize_segmented"] = {"max_iters": GP40K_SEGMENTED_STEPS, **GP_ITER_TRAIN, "surrogate": r.losses.tolist(),
                                 "runs_identical": identical_s,
                                 "nlml_chol_f64_after": after([p.detach() for _, p in model._leaves()]),
                                 "steps": steps, "second_run": st}
    emit({**out, "card": card})
    check(all(np.isfinite(v) for v in (nl_fused, nl_sep, loss, nl16)) and bool(torch.isfinite(grad).all()),
          "gp40k: a non-finite NLML or gradient")
    check(out["nlml_fused"]["cg_iterations"] < GP_ITER["cg_iters"],
          "gp40k: the fused NLML's CG used its whole budget without meeting cg_tol")
    for key, tol in GP40K_RTOL.items():
        check(gaps[key] <= tol, f"gp40k: float32 {key} off the float64 Cholesky model by {gaps[key]:.3e}")
    check(mixed_gap <= GP_MIXED16_RTOL, f"gp40k: mixed16 NLML off the plain one by {mixed_gap:.3e}")
    for what in ("optimize", "optimize_segmented"):
        check(out[what]["runs_identical"], f"gp40k: two {what} runs from the same start differ")
        check(out[what]["nlml_chol_f64_after"] < exact["nlml"],
              f"gp40k: {what} raised the Cholesky NLML ({exact['nlml']} -> {out[what]['nlml_chol_f64_after']})")
    del model, m64
    torch.cuda.empty_cache()
    return out


def phase_gp500k(card: str) -> dict:
    """gp500k_matfree: the recipe at n = 500,000.  One float32 apply at B = 9
    against float64 rows computed directly for 256 sampled rows, its time
    and busy share beside the bound; then one segmented NLML at
    GP500K_NLML_N, finite, its CG within budget (it stops only on cg_tol or
    on the budget)."""
    import copy

    import torch
    from gp_grief_tpu_torch.models.gp_regression import _cov_any

    cfg = GP_ITER_CONFIGS["gp500k_matfree"]
    n = cfg["n"]
    x, y = gp_iter_data(n)
    model = gp_iter_model(x, y, torch.float32, DEVICE, matvec_chunk=cfg["matvec_chunk"])
    chunk = model._iter_opts["matvec_chunk"]
    B = 1 + GP_ITER["num_probes"]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    vv = torch.randn((B, n), device=DEVICE, generator=gen)
    rows = torch.randperm(n, device=DEVICE, generator=gen)[:256]
    mv = model._gram_op(chunk)
    with torch.no_grad():
        got, st = run_measured(lambda: mv(vv))
        got = got[:, rows]
        x64, v64, k64 = model.x.double(), vv.double(), copy.deepcopy(model.kernel).double()
        want = v64 @ _cov_any(k64, x64[rows], x64).T + torch.exp(model.log_noise).double() * v64[:, rows]
    apply_err = rel_err(got, want)
    del model, mv, x64, v64, want
    torch.cuda.empty_cache()
    out = {"phase": "gp_iter", "config": "gp500k_matfree", "n": n, "matvec_chunk": chunk, **GP_ITER,
           "apply": {"B": B, **st, "bound_ms": gram_apply_bound_ms(n, B), "bound_by": "operations",
                     "rows_checked": 256, "rel_err_vs_f64": apply_err, "tol": GP500K_APPLY_RTOL}}
    x, y = gp_iter_data(GP500K_NLML_N)
    model = gp_iter_model(x, y, torch.float32, DEVICE, matvec_chunk=cfg["matvec_chunk"])
    nlml, st = run_measured(lambda: -model.log_likelihood_iterative_segmented(**GP_ITER_NLML))
    out["nlml_fused"] = {"n": GP500K_NLML_N, "matvec_chunk": model._iter_opts["matvec_chunk"], "nlml": nlml,
                         "cg_iterations": model.cg_iterations, **st}
    emit({**out, "card": card})
    check(apply_err <= GP500K_APPLY_RTOL, f"gp500k: the float32 apply is off float64 rows by {apply_err:.3e}")
    check(np.isfinite(nlml), "gp500k: the NLML is not finite")
    check(model.cg_iterations < GP_ITER["cg_iters"],
          f"gp500k: CG used its whole budget ({model.cg_iterations} iterations) without meeting cg_tol")
    del model
    torch.cuda.empty_cache()
    return out


def phase_gp_iter_train(card: str, n: int) -> dict:
    """The recipe's ``optimize_segmented`` steps at ``n`` (matvec_chunk
    "auto"): each step's solve and gradient wall and CG iterations, the
    run's busy share; the steps finite and each solve within the CG budget.
    Whether they lower the NLML is held at gp40k, against the Cholesky
    model."""
    import torch

    x, y = gp_iter_data(n)
    model = gp_iter_model(x, y, torch.float32, DEVICE, matvec_chunk="auto")
    with StepStats({}, False) as stats:
        res, st = run_measured(lambda: model.optimize_segmented(
            max_iters=GP_ITER_TRAIN_STEPS, callback=lambda it, value, info: stats.step(surrogate=value, **info),
            **GP_ITER_TRAIN))
    st.pop("peak_gb")  # StepStats resets the peak each step: the rows carry it
    out = {"phase": "gp_iter_train", "n": n, "matvec_chunk": model._iter_opts["matvec_chunk"], **GP_ITER,
           **GP_ITER_TRAIN, "max_iters": GP_ITER_TRAIN_STEPS, "surrogate": res.losses.tolist(), "steps": stats.rows,
           **st}
    emit({**out, "card": card})
    check(np.all(np.isfinite(res.losses)) and all(bool(torch.isfinite(p).all()) for _, p in model._leaves()),
          f"gp_iter_train at n = {n}: non-finite")
    check(all(r["cg_iterations"] < GP_ITER["cg_iters"] for r in stats.rows),
          f"gp_iter_train at n = {n}: a step's solve used the whole CG budget")
    del model
    torch.cuda.empty_cache()
    return out


def phase_gp_iter(card: str) -> None:
    """Phase 13: GPRegression's iterative path (see the module docstring)."""
    ref = phase_gp_iter_f64(json.load(open(GP_ITER_REFERENCE)))
    emit({"phase": "gp_iter_f64", **ref, "card": card})
    phase_gp40k(card)
    phase_gp500k(card)
    phase_gp_iter_train(card, GP_ITER_TRAIN_N)


# ---------------------------------------------------------------------------
# Phase 15: the multi-device layer (gp_grief_tpu_torch.parallel) on the card.
# Each case runs on ranks spawned by parallel.launch.spawn: at world 2 on gloo
# with both ranks on cuda:0 (NCCL refuses two ranks on one card: "Duplicate
# GPU detected"), then GRIEF and grid at world 1 on NCCL, the backend a
# multi-GPU user runs.  Each rank resets the kernels' counts just before its
# case's main path and reads them just after; the ranks' sums are the
# kernels line's ``parallel_launches``.
# ---------------------------------------------------------------------------

PARALLEL_RUNS = (("gloo", 2, ("uci2m", "grid8x512x512_exact", "ski1m_lattice", "ski100k_data")),
                 ("nccl", 1, ("uci2m", "grid8x512x512_exact")))
PARALLEL_TRAIN = dict(optimizer="adam", max_iters=3, learning_rate=0.05)
# Limits of the sharded runs' gaps, relative: GRIEF's NLML, gradient (its
# largest component), mean and variance (their scale) against the
# single-device model on the card at the same parameters; the grid NLML
# against the float64 Schur NLML (the CG NLML's own limit); SKI's NLML, and
# ski1m's segmented NLML, against the single-device model's with the same
# probes.  About three times the gaps first measured at world 2 on an NVIDIA
# H100 80GB HBM3, 700.00 W (PERF.md §6: 0, 8.77e-7, 5.34e-7, 2.01e-7;
# 2.27e-7, 5.23e-7 and 1.13e-6; world 1 on NCCL measured 0 for GRIEF); the
# NLML's 0 gets four float32 epsilons.
PARALLEL_RTOL = {"uci2m_nlml": 5e-7, "uci2m_grad": 3e-6, "uci2m_mean": 1.6e-6, "uci2m_var": 6e-7,
                 "grid8x512x512_exact": GRID_CG_GAP_RTOL, "ski1m_lattice": 7e-7, "ski100k_data": 1.6e-6,
                 "ski1m_lattice_segmented": 3.5e-6}
PARALLEL_TIMEOUT = 900.0


class RowBlockProbes:
    """:class:`NumpyProbes` for one rank of a sharded model: a draw of this
    rank's ``n_loc`` rows is its block of the ``(R, n_pad)`` probes the
    single-device model draws; any other draw (the lattice dual's replicated
    ``(R, M)`` probes) is the whole matrix."""

    def __init__(self, n_pad: int, rows: slice):
        self.calls, self.n_pad, self.rows = 0, n_pad, rows

    def __call__(self, shape, *, dtype, device, generator):
        import torch

        shape = tuple(int(s) for s in shape)
        if shape[1] == self.rows.stop - self.rows.start:
            z = ski_probe(self.calls, (shape[0], self.n_pad))[:, self.rows]
        else:
            z = ski_probe(self.calls, shape)
        self.calls += 1
        return torch.as_tensor(z, dtype=dtype, device=device)


def _same_bits(a, b) -> bool:
    return bool(np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)))


def _parallel_uci2m(torch, gpt, par, model_grad):
    xtr, ytr, xte, _ = uci2m_data()
    grid = gpt.InducingGrid.build(xtr[:200000], mbar=10)

    def build():
        return par.ShardedGPGriefModel(xtr, ytr, gpt.make_kernel("rbf", lengthscale=1.0, input_dim=1), grid,
                                       n_eigs=400, noise_var=0.2, dtype=torch.float32, device="cuda")

    def run():
        model = build()
        nlml0, grad0 = model_grad(model)
        res = model.optimize(**PARALLEL_TRAIN)
        again = build()
        res2 = again.optimize(**PARALLEL_TRAIN)
        mean, var = model.predict(xte)
        return {"nlml0": nlml0, "grad0": grad0, "losses": np.asarray(res.losses),
                "same_bits": _same_bits(model.parameters, again.parameters) and _same_bits(res.losses, res2.losses),
                "nlml_after": -model.log_likelihood(), "params": model.parameters,
                "mean": mean.cpu().numpy(), "var": var.cpu().numpy(), "rows_per_rank": int(model.x.shape[0])}, model

    return run, lambda model: model_grad(model)


def _parallel_grid(torch, gpt, par, model_grad):
    name = "grid8x512x512_exact"
    xg, y = grid_data(name)
    world = torch.distributed.get_world_size()

    def run():
        mesh = par.make_mesh((world,), ("model",), device_type="cuda")
        model = grid_model(name, xg, y, torch.float32, "cuda", mesh=mesh)
        nlml = -model.log_likelihood()
        return {"nlml": nlml, "cg_iterations": model.cg_info.iterations}, model

    return run, lambda model: model.log_likelihood()


def _parallel_ski(name, torch, gpt, par, model_grad):
    import gp_grief_tpu_torch.ops.lanczos as tlz

    cfg = SKI_CONFIGS[name]
    x, y, xg = ski_data(name)

    def run():
        kerns = [gpt.make_kernel("rbf", lengthscale=cfg["lengthscale"]) for _ in range(SKI_D)]
        model = par.ShardedGPSKIRegression(x, y, kerns, xg, noise_var=cfg["noise_var"], dtype=torch.float32,
                                           device="cuda", **cfg["model"])
        n_loc = int(model.x.shape[0])
        rows = slice(model.rank * n_loc, (model.rank + 1) * n_loc)
        draw, tlz.rademacher = tlz.rademacher, RowBlockProbes(model.n_pad, rows)
        try:
            nlml = -model.log_likelihood()
        finally:
            tlz.rademacher = draw
        out = {"nlml": nlml, "cg_iterations": model.cg_info.iterations, "rows_per_rank": n_loc}
        if cfg["model"]["solver"] == "lattice":
            ll = model.log_likelihood()
            ll_seg = model.log_likelihood_segmented()
            res = model.optimize_segmented(max_iters=1, learning_rate=0.05, num_probes=8)
            out.update(nlml_own=-ll, nlml_segmented=-ll_seg, step_surrogate=float(res.losses[0]),
                       step_cg_iterations=model.cg_iterations)
        return out, model

    return run, lambda model: model.log_likelihood()


def parallel_rank(cases) -> list:
    """One rank of phase 15: each case's main path, with this rank's kernel
    launches, collectives (calls, bytes, host seconds), wall, peak memory
    and the device time of one profiled NLML (gradient included for GRIEF)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch import parallel as par
    from gp_grief_tpu_torch.ops.cuda import interp_wt, kron_matvec_fused, kron_matvec_slab, phi_fused, wtw_stencil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"K1": phi_fused, "K2": kron_matvec_slab, "K3": kron_matvec_fused, "K4": interp_wt, "K5": wtw_stencil}

    def model_grad(model):
        model.zero_grad()
        loss = model._loss()
        loss.backward()
        return float(loss.detach()), np.concatenate([p.grad.detach().cpu().numpy().reshape(-1)
                                                      for _, p in model._leaves()])

    outs = []
    for case in cases:
        if case == "uci2m":
            run, measure = _parallel_uci2m(torch, gpt, par, model_grad)
        elif case in GRID_CONFIGS:
            run, measure = _parallel_grid(torch, gpt, par, model_grad)
        else:
            run, measure = _parallel_ski(case, torch, gpt, par, model_grad)
        torch.cuda.empty_cache()
        dist.barrier()
        for fn in counters.values():
            fn.launches = 0
        par.collectives.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, model = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        stats = {k: dict(v) for k, v in par.collectives.STATS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            measure(model)
            torch.cuda.synchronize()
            nlml_wall = time.perf_counter() - t0
        dev_ms, items = device_items(prof, top=5)
        del model
        outs.append({"case": case, "rank": dist.get_rank(), "world": dist.get_world_size(),
                     "backend": dist.get_backend(), "device": torch.cuda.current_device(), "result": result,
                     "launches": launches, "collectives": stats, "wall_s": wall, "peak_gb": peak,
                     "nlml_wall_ms": nlml_wall * 1e3, "nlml_device_ms": dev_ms, "device_items": items})
    return outs


def _parallel_references(cases) -> dict:
    """The single-device yardsticks on the card (this process): GRIEF's NLML
    and gradient at init and the model for its predictions; each SKI case's
    float32 NLML with the numpy probes (``ski_nlml``) and, for the lattice,
    its segmented NLML with the model's own probes (``ski_segmented``)."""
    import torch

    import gp_grief_tpu_torch as gpt

    refs = {"ski_nlml": {}, "ski_segmented": {}}
    if "uci2m" in cases:
        xtr, ytr, xte, _ = uci2m_data()
        grid = gpt.InducingGrid.build(xtr[:200000], mbar=10)
        ref = gpt.GPGriefModel(xtr, ytr, gpt.make_kernel("rbf", lengthscale=1.0, input_dim=1), grid, n_eigs=400,
                               noise_var=0.2, opt_kernel_params=True, dtype=torch.float32, device="cuda")
        ref.phi_impl = "fused"  # K1 forward, the plain version's VJP backward: no (d, n, p) saved per chunk
        ref.zero_grad()
        loss = ref._loss()
        loss.backward()
        refs["uci2m"] = {"model": ref, "xte": xte, "nlml0": float(loss.detach()),
                         "grad0": np.concatenate([p.grad.detach().cpu().numpy().reshape(-1)
                                                  for _, p in ref._leaves()])}
    for name in SKI_CONFIGS:
        if name in cases:
            x, y, xg = ski_data(name)
            model = ski_model(name, x, y, xg, torch.float32)
            refs["ski_nlml"][name] = with_numpy_probes(lambda: -model.log_likelihood())
            if SKI_CONFIGS[name]["model"]["solver"] == "lattice":
                refs["ski_segmented"][name] = -model.log_likelihood_segmented()
            del model
            torch.cuda.empty_cache()
    return refs


def phase_parallel(card: str) -> dict:
    """Phase 15: every sharded path on the card; returns the ranks' summed
    launches per kernel."""
    import torch

    from gp_grief_tpu_torch.parallel.launch import spawn

    torch.cuda.empty_cache()
    all_cases = {c for _, _, cases in PARALLEL_RUNS for c in cases}
    refs, t_refs = timed(lambda: _parallel_references(all_cases))
    totals = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    emit({"phase": "parallel_refs", "s": t_refs, "ski_nlml_f32": refs["ski_nlml"],
          "ski_segmented_f32": refs["ski_segmented"], "card": card})
    failed = []
    for backend, world, cases in PARALLEL_RUNS:
        outs, t_spawn = timed(lambda: spawn(parallel_rank, world, args=(cases,), backend=backend, device="cuda",
                                            timeout=PARALLEL_TIMEOUT))
        for i, case in enumerate(cases):
            per_rank = [o[i] for o in outs]
            r0 = per_rank[0]["result"]
            line = {"phase": "parallel", "case": case, "backend": backend, "world": world,
                    "devices": [p["device"] for p in per_rank], "spawn_s": t_spawn,
                    "wall_s": [p["wall_s"] for p in per_rank], "peak_gb": [p["peak_gb"] for p in per_rank],
                    "nlml_wall_ms": [p["nlml_wall_ms"] for p in per_rank],
                    "nlml_device_ms": [p["nlml_device_ms"] for p in per_rank],
                    "launches": [p["launches"] for p in per_rank],
                    "collectives": [p["collectives"] for p in per_rank],
                    "device_items": per_rank[0]["device_items"]}
            gaps, checks = {}, []
            if case == "uci2m":
                ref = refs["uci2m"]
                gaps["uci2m_nlml"] = abs(r0["nlml0"] - ref["nlml0"]) / abs(ref["nlml0"])
                gaps["uci2m_grad"] = rel_err(r0["grad0"], ref["grad0"])
                model = ref["model"]
                model.parameters = r0["params"]
                with torch.no_grad():
                    mean, var = model.predict(ref["xte"])
                gaps["uci2m_mean"] = rel_err(r0["mean"], mean.cpu().numpy())
                gaps["uci2m_var"] = rel_err(r0["var"], var.cpu().numpy())
                line.update(nlml=[r0["nlml0"], r0["nlml_after"]], ref_nlml=ref["nlml0"], losses=r0["losses"].tolist(),
                            runs_bit_identical=r0["same_bits"], rows_per_rank=r0["rows_per_rank"])
                checks += [(r0["same_bits"], "the two training runs differ"),
                           (r0["nlml_after"] < r0["nlml0"], "the NLML did not fall in training"),
                           (all(p["launches"]["K1"] > 0 for p in per_rank), "a rank never launched K1"),
                           (all(_same_bits(p["result"]["params"], r0["params"]) for p in per_rank),
                            "the ranks' parameters differ")]
            elif case in GRID_CONFIGS:
                ref = JAX_GRID_NLML_F64[case]
                gaps[case] = abs(r0["nlml"] - ref) / abs(ref)
                line.update(nlml=r0["nlml"], nlml_f64_schur=ref, cg_iterations=r0["cg_iterations"])
                checks.append((all(p["launches"]["K3"] > 0 for p in per_rank), "a rank never launched K3"))
            else:
                ref = refs["ski_nlml"][case]
                gaps[case] = abs(r0["nlml"] - ref) / abs(ref)
                line.update({k: v for k, v in r0.items()}, ref_nlml=ref)
                kernel = "K5" if SKI_CONFIGS[case]["model"]["solver"] == "lattice" else "K4"
                checks.append((all(p["launches"][kernel] > 0 for p in per_rank), f"a rank never launched {kernel}"))
                if "nlml_segmented" in r0:
                    ref_seg = refs["ski_segmented"][case]
                    gaps[case + "_segmented"] = abs(r0["nlml_segmented"] - ref_seg) / abs(ref_seg)
                    line.update(ref_nlml_segmented=ref_seg)
                    checks.append((np.isfinite(r0["step_surrogate"]), "non-finite optimize_segmented step"))
            checks.append((all(abs(p["result"].get("nlml", p["result"].get("nlml0"))
                                   - r0.get("nlml", r0.get("nlml0"))) == 0 for p in per_rank),
                           "the ranks' NLMLs differ"))
            line["gaps"] = {k: [v, PARALLEL_RTOL[k]] for k, v in gaps.items()}
            emit({**line, "card": card})
            checks += [(v <= PARALLEL_RTOL[k], f"{k} gap {v:.3e} > {PARALLEL_RTOL[k]}") for k, v in gaps.items()]
            failed += [f"parallel {case} ({backend}, world {world}): {msg}" for ok, msg in checks if not ok]
            for p in per_rank:
                for k in totals:
                    totals[k] += p["launches"][k]
        # Every case's line first, then any failure.
        check(not failed, "; ".join(failed))
    del refs
    torch.cuda.empty_cache()
    return totals


BENCH_TIMEOUT = 300


def phase_bench(card: str) -> dict:
    """Phase 16: ``python -m gp_grief_tpu_torch bench`` on the card (a
    subprocess, as phase 14c runs ``checkgrad``), its last line parsed and
    checked.  Returns the bench's record."""
    from gp_grief_tpu_torch.bench import REL_ERR_MAX

    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "gp_grief_tpu_torch", "bench"], capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = cli.stdout.splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, ValueError):
        rec = None
    emit({"phase": "bench", "returncode": cli.returncode, "s": time.perf_counter() - t0, "bench": rec, "card": card})
    check(cli.returncode == 0 and isinstance(rec, dict),
          f"bench on the card: exit {cli.returncode}, {cli.stdout[-2000:]}{cli.stderr[-2000:]}")
    det = rec["detail"]
    for key in ("value", "stream_GBs", "x3_grade_GBs"):
        value = rec[key] if key == "value" else det[key]
        check(isinstance(value, float) and np.isfinite(value) and value > 0, f"bench: {key} is {value!r}")
    check(det["matvec_rel_err"] <= REL_ERR_MAX["default"] and det["x3_rel_err"] <= REL_ERR_MAX["highest"],
          f"bench: errors {det['matvec_rel_err']} / {det['x3_rel_err']} against float64 (limits {REL_ERR_MAX})")
    check(det["route"] == "slab", f"bench: the matvec took route {det['route']!r}, not K2")
    check(det["launches"]["matvec"] > 0 and det["launches"]["x3_exact_tile"] > 0,
          f"bench: K2 launches {det['launches']}")
    check(set(det["kernels"]["matvec"]) == {"kron_mma_tile_kernel"}
          and set(det["kernels"]["x3"]) == {"kron_exact_tile_kernel"},
          f"bench: kernels {det['kernels']}, not K2's mma tile member at 'default' and its exact tile member at x3")
    return rec


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

    # Phases 3, 6, 8 and 10 (the kernels against their plain versions) run here,
    # before the paths, so a wrong kernel stops the script early.
    k1 = phase_kernel(card)
    kron = phase_kron(card)
    ski_k = phase_ski_kernels(card)
    axes = phase_kron_axes(card)

    from gp_grief_tpu_torch.ops.cuda import (
        interp_wt, kron_matmat_cuda, kron_matvec_fused, kron_matvec_slab, last_slab_pass, tail2_pass, tail3_pass,
        wtw_stencil,
    )

    counters = (phi_fused, kron_matvec_slab, kron_matvec_fused, interp_wt, wtw_stencil, kron_matmat_cuda,
                last_slab_pass, tail3_pass, tail2_pass)

    def reset():
        for fn in counters:
            fn.launches = 0
            if hasattr(fn, "exact_tile_launches"):
                fn.exact_tile_launches = 0

    def exact_counts(entry, fn, key="exact_tile_launches"):
        # Of the entry's launches, those on the exact grade's tile member.
        if hasattr(fn, "exact_tile_launches"):
            entry[key] = fn.exact_tile_launches

    entries = []
    # Phases 4-5 and the configs phase: the GP-GRIEF path (and sine1d's exact
    # GP, grid3d's grid GP).  Count K1's launches over exactly these runs.
    reset()
    phase_kin40k(card)
    phase_uci2m(card)
    phase_configs(card)
    check(phi_fused.launches > 0, "the GP-GRIEF path never launched K1")
    entries.append(
        {"name": "phi_fused", "route": "cuda", "source": "gp_grief_tpu_torch/csrc/phi_fused.cu",
         "replaces": "gp_grief_tpu/ops/pallas/phi_pallas.py:93", "launches": phi_fused.launches,
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "device_ms": k1["device_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
         "uci2m_chunk_ms": k1["uci2m_chunk_ms"], "uci2m_chunk_device_ms": k1["uci2m_chunk_device_ms"],
         "d100_ms": k1["d100_ms"], "d100_device_ms": k1["d100_device_ms"]})

    # Phase 7: the grid GP path.
    reset()
    for name in GRID_CONFIGS:
        phase_grid(card, name)
    check(kron_matvec_slab.launches > 0 and kron_matvec_fused.launches > 0,
          "the grid path never launched K2 or K3")
    for name, replaces, fn in (("kron_slab", "gp_grief_tpu/ops/pallas/kron_pallas.py:1094", kron_matvec_slab),
                               ("kron_fused", "gp_grief_tpu/ops/pallas/kron_pallas.py:1036", kron_matvec_fused)):
        k = kron[name]
        entries.append({"name": name, "route": "cuda", "source": "gp_grief_tpu_torch/csrc/kron_pass.cu",
                        "replaces": replaces, "launches": fn.launches, "max_abs_err": k["max_abs_err"],
                        "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
                        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                        "chain_ms": k["chain_ms"], **({"x3": k["x3"]} if "x3" in k else {})})
        exact_counts(entries[-1], fn)

    # Phase 9: the SKI path.  The float64 runs (parity, and the float32 runs'
    # yardstick) come first; the launches count the float32 runs alone.
    reference = load_ski_reference()
    ref64 = {name: phase_ski_f64(name, reference) for name in SKI_CONFIGS}
    reset()
    per_nlml = {name: phase_ski(card, name, ref64[name]) for name in SKI_CONFIGS}
    check(per_nlml["ski100k_data"]["K4"] > 0, "ski100k_data's NLML never launched K4")
    check(per_nlml["ski1m_lattice"]["K5"] > 0, "ski1m_lattice's NLML never launched K5")
    for name, key, replaces, fn in (("interp_wt", "K4", "gp_grief_tpu/ops/interp.py:712", interp_wt),
                                    ("wtw_stencil", "K5", "gp_grief_tpu/ops/interp_stencil.py:396", wtw_stencil)):
        check(fn.launches > 0, f"the SKI path never launched {name}")
        k = ski_k[name]
        entries.append({"name": name, "route": "cuda", "source": f"gp_grief_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces, "launches": fn.launches, "max_abs_err": k["max_abs_err"],
                        "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
                        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                        "launches_per_nlml": {c: per_nlml[c][key] for c in SKI_CONFIGS},
                        **({"members": k["members"]} if "members" in k else {})})

    # Phase 10: the per-axis passes' path (K7 as a CG operator, K6-K8 at the
    # 32^5 shapes).
    reset()
    phase_kron_axes_path(card)
    for name, replaces, fn in (("kron_matmat_cuda", "gp_grief_tpu/ops/pallas/kron_pallas.py:108", kron_matmat_cuda),
                               ("last_slab_pass", "gp_grief_tpu/ops/pallas/kron_pallas.py:46", last_slab_pass),
                               ("tail3_pass", "gp_grief_tpu/ops/pallas/kron_pallas.py:525", tail3_pass),
                               ("tail2_pass", "gp_grief_tpu/ops/pallas/kron_pallas.py:590", tail2_pass)):
        check(fn.launches > 0, f"the phase-10 path never launched {name}")
        k = axes[name]
        entries.append({"name": name, "route": "cuda", "source": "gp_grief_tpu_torch/csrc/kron_pass.cu",
                        "replaces": replaces, "launches": fn.launches, "max_abs_err": k["max_abs_err"],
                        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "bound_by": k["bound_by"], "library_ms": k["library_ms"], "shape": k["shape"],
                        "device_ms": k["device_ms"], **({"chain_ms": k["chain_ms"]} if "chain_ms" in k else {})})
        exact_counts(entries[-1], fn)

    # Phases 11-12: training through the iterative solvers (the grid model's CG
    # implicit gradient, SKI's BBMM surrogates).
    reset()
    for name in GRID_CONFIGS:
        phase_grid_train(card, name)
    for name in SKI_CONFIGS:
        phase_ski_train(card, name)
    check([e["name"] for e in entries] == ["phi_fused", "kron_slab", "kron_fused", "interp_wt", "wtw_stencil",
                                           "kron_matmat_cuda", "last_slab_pass", "tail3_pass", "tail2_pass"],
          "the kernels line's entries are out of the counters' order")
    for entry, fn in zip(entries, counters):
        entry["training_launches"] = fn.launches
        exact_counts(entry, fn, "training_exact_tile_launches")
    for fn in (kron_matvec_slab, kron_matvec_fused, interp_wt, wtw_stencil):
        check(fn.launches > 0, f"the training phases never launched {fn.__name__}")

    # Phase 13: GPRegression's iterative path, which launches no kernel of the
    # port (its Gram slabs are PyTorch ops).
    phase_gp_iter(card)

    # Phase 15: the sharded paths, on ranks of their own; each rank counts its
    # launches from 0 over its cases' main paths, and the ranks' sums are
    # ``parallel_launches``.
    par_launches = phase_parallel(card)
    for key in ("K1", "K3", "K4", "K5"):
        check(par_launches[key] > 0, f"the sharded paths never launched {key}")
    for entry, key in zip(entries, ("K1", "K2", "K3", "K4", "K5", None, None, None, None)):
        entry["parallel_launches"] = par_launches[key] if key else 0

    # Phase 16: the headline benchmark, in a process of its own; its K2
    # launches are that process's.
    entries[1]["bench_launches"] = phase_bench(card)["detail"]["launches"]

    print(card, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
