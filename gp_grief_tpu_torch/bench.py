"""The headline benchmark: the Kronecker matvec's effective bandwidth.

Counterpart of the repository's ``bench.py`` (``python -m gp_grief_tpu
bench``), which measures the metric of ``BASELINE.json``: the Kronecker
matvec's effective GB/s at 5 × 32 (M = 2²⁵) at the solvers' hot-loop grade,
against 70 % of a stream measured in the same process.

Workload: ``(⊗_d K_d)·v`` with d factors of m_d × m_d (default 5 × 32: a
134 MB float32 vector).  The factors are ``bench.py``'s NumPy draw, so both
packages bench the same operator; the vector comes from a
``torch.Generator`` seeded 0 on the chosen device.

Phases:

* ``matvec`` — ``ops.kron_fast.kron_matvec_fast(..., precision="default")``,
  the refined-CG inner loop's grade.  On the card it must route to K2
  (``kernel_route`` says ``"slab"``) and every application must launch the
  pass plan's passes, else the phase raises: a gate change does not quietly
  bench the chain.  On the CPU it runs the chain.
* ``stream`` — y ← 2y + 1 as one elementwise pass (M floats read, M
  written; ``torch.add(one, y, alpha=2)``, ``one`` a host scalar), the
  memory rate this process reaches.  On the card the profiler must count
  one kernel an application.
* ``x3`` — ``ops.cuda.kron.kron_matvec_slab(..., precision="highest")``,
  K2's exact grade, gated by ``slab_schedule_applicable`` as in
  ``bench.py``; skipped on the CPU.

Timing, ``bench.py``'s method: chains of 5 and 5 + N dependent applications
(N = 50, and 100 for the stream), one warm chain first (on the card it also
builds the kernels), the best of 3 of each length, the time of one
application the slope between them.  CUDA events on the current stream time
the chains on the card, the host clock on the CPU.  The calls are eager, so
the host must keep ahead of the card: ``busy_share`` is one more long
chain's device time (``torch.profiler``) over the best timed long chain's
(unprofiled), and reads below 1 where the host falls behind.  No CUDA
graph.

Each grade is applied once more and held to the float64 product
(``kron_chain_ref`` on float64 copies), relative in norm; a grade beyond
``REL_ERR_MAX`` fails the command.  Every failure raises: the command then
exits non-zero and prints no result.

Output: one JSON line, last, with ``bench.py``'s keys: ``value`` is the
effective rate, ``bench.py``'s byte count 2·d·M·4 (each axis read and
written once) over the time of one application, so that both packages'
numbers mean the same thing; ``vs_baseline`` is ``value`` over 0.7 × this
run's stream rate.  K2 contracts the axes in fewer passes than d, so the
effective rate can exceed the card's memory rate; ``detail.bytes`` and
``detail.GBs`` give beside it the bytes K2's passes move and the
function's own (the float32 input read and the output written once, as the
kernels' bounds count them).

Run: ``python -m gp_grief_tpu_torch bench [--d D] [--m_d M] [--device cpu]``
(or ``python -m gp_grief_tpu_torch.bench``); on the card unless
``--device cpu``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from gp_grief_tpu_torch.__main__ import _option
from gp_grief_tpu_torch.ops.cuda.kron import _hopper_plan, kron_chain_ref, kron_matvec_slab, slab_schedule_applicable
from gp_grief_tpu_torch.ops.kron_fast import kernel_route, kron_matvec_fast

__all__ = ["REL_ERR_MAX", "bench_factors", "bench_vector", "main", "matvec_step", "run", "x3_step"]

USAGE = "usage: bench [--d D] [--m_d M] [--device cpu]  (D, M: positive integers; default 5 and 32)"
SHORT = 5  # the short chain; the long one is SHORT + ITERS[phase]
ITERS = {"matvec": 50, "stream": 100, "x3": 50}
REPS = 3
TARGET_SHARE = 0.70
# Relative norm error of one application against the float64 product.
# "default": bf16 operands in every contraction; about three times the
# 5.24e-3 this command measured at 5 x 32 on an H100 (PERF.md §2).
# "highest": chip_smoke.py's KRON_TOL for the exact grade.
REL_ERR_MAX = {"default": 1.6e-2, "highest": 1e-5}
# The matvec phase's grade, in words true of K2 (route "slab").
GRADE = ("float32 vector and factors, precision 'default': every contraction's operands rounded to bf16, float32 "
         "accumulation; on K2 (route 'slab') bf16 mma.sync tile passes where that member takes the pass, bf16 "
         "storage between passes")
# csrc/kron_pass.cu's members, by the kernel names the profiler reports.
_MEMBERS = ("kron_exact_tile_kernel", "kron_mma_tile_kernel", "kron_tile_kernel", "kron_wide_kernel")

_T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def bench_factors(d: int, m_d: int, device) -> list:
    """``bench.py``'s factors: d draws of ``standard_normal((m_d, m_d)) /
    (2.2·√m_d)`` from ``np.random.default_rng(0)`` (about unit spectral
    radius, so chained applications stay finite), float32."""
    rng = np.random.default_rng(0)
    return [torch.as_tensor((rng.standard_normal((m_d, m_d)) / (2.2 * np.sqrt(m_d))).astype(np.float32),
                            device=device) for _ in range(d)]


def bench_vector(m: int, device) -> torch.Tensor:
    """The float32 vector, drawn on ``device`` from a generator seeded 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(m, generator=gen, device=device)


def _plan(factors) -> tuple[int, int]:
    """K2's passes for these factors at B = 1, and how many are tile passes
    (those the exact grade runs on its exact tile member)."""
    ms = [int(K.shape[0]) for K in factors]
    plan = _hopper_plan(ms, ms, 1)
    return len(plan), sum(P != 0 for _, _, P in plan)


def _counted(apply, passes: int, exact_passes: int):
    """``apply``, raising unless each call launches K2's ``passes`` passes,
    ``exact_passes`` of them on the exact tile member."""
    def step(x):
        launches, exact = kron_matvec_slab.launches, kron_matvec_slab.exact_tile_launches
        y = apply(x)
        got = (kron_matvec_slab.launches - launches, kron_matvec_slab.exact_tile_launches - exact)
        if got != (passes, exact_passes):
            raise RuntimeError(f"bench: one application launched {got[0]} K2 passes ({got[1]} on the exact tile "
                               f"member); K2's plan has {passes} ({exact_passes})")
        return y
    return step


def matvec_step(factors, v) -> tuple:
    """The matvec phase's application, ``kron_matvec_fast`` at "default",
    and its route.  On the card the route must be K2's (``"slab"``)."""
    route = kernel_route(factors, 1, "default", vector_dtype=v.dtype if v.is_cuda else None)

    def apply(x):
        return kron_matvec_fast(factors, x, precision="default")

    if not v.is_cuda:
        return apply, route
    if route != "slab":
        raise RuntimeError(f"bench: kron_matvec_fast routes {[int(K.shape[0]) for K in factors]} to {route!r}; "
                           "the bench measures K2 ('slab')")
    return _counted(apply, _plan(factors)[0], 0), route


def x3_step(factors, v):
    """The x3 phase's application, K2 at "highest" (every tile pass on the
    exact tile member), or the reason the phase is skipped."""
    if not v.is_cuda:
        return f"skipped(device={v.device.type})"
    if not slab_schedule_applicable(factors, 1):
        return "skipped(shape: slab not applicable)"
    passes, tiles = _plan(factors)
    return _counted(lambda x: kron_matvec_slab(factors, x, precision="highest"), passes, tiles)


def _chain_seconds(step, v, n: int) -> float:
    """Seconds for ``n`` dependent applications of ``step`` from ``v``: CUDA
    events on the current stream on the card, the host clock on the CPU."""
    if v.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    x = v
    for _ in range(n):
        x = step(x)
    if v.is_cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return time.perf_counter() - t0


def _chains(step, v, iters: int) -> tuple[float, float]:
    """The slope between the best of ``REPS`` chains of ``SHORT`` and
    ``SHORT + iters`` applications, after one warm chain; and the best long
    chain's seconds."""
    _chain_seconds(step, v, SHORT + iters)
    t_long = min(_chain_seconds(step, v, SHORT + iters) for _ in range(REPS))
    t_short = min(_chain_seconds(step, v, SHORT) for _ in range(REPS))
    return max((t_long - t_short) / iters, 1e-12), t_long


def _profiled_chain(step, v, n: int) -> tuple[float, dict]:
    """One chain of ``n`` applications on the card under ``torch.profiler``:
    its kernels' device seconds, and the kernels by Kronecker member or
    name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x = v
        for _ in range(n):
            x = step(x)
        torch.cuda.synchronize()
    device_us, kernels = 0.0, {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us > 0:
            device_us += us
            label = next((m for m in _MEMBERS if m in ev.key), ev.key[:60])
            kernels[label] = kernels.get(label, 0) + ev.count
    return device_us / 1e6, kernels


def _rel_err(got: torch.Tensor, factors, v: torch.Tensor) -> float:
    """Relative norm error of ``got`` against the float64 product."""
    exact = kron_chain_ref([K.double() for K in factors], v.double()[:, None])[:, 0]
    return float(torch.linalg.norm(got.double() - exact) / torch.linalg.norm(exact))


def _check_err(phase: str, err: float, precision: str) -> None:
    if not err <= REL_ERR_MAX[precision]:
        raise RuntimeError(f"bench: {phase} is {err:.3e} from the float64 product (limit {REL_ERR_MAX[precision]})")


def _measure(phase: str, step, v) -> dict:
    """Time one application of ``step`` and, on the card, profile a long
    chain: the busy share is its device time over the best unprofiled long
    chain's (the profiler's own host cost kept out); the K2 launches the
    phase made."""
    launches, exact = kron_matvec_slab.launches, kron_matvec_slab.exact_tile_launches
    t, t_long = _chains(step, v, ITERS[phase])
    out = {"s": t, "busy_share": None, "kernels": None}
    if v.is_cuda:
        device_s, out["kernels"] = _profiled_chain(step, v, SHORT + ITERS[phase])
        out["busy_share"] = device_s / t_long
    out["launches"] = kron_matvec_slab.launches - launches
    out["exact_tile_launches"] = kron_matvec_slab.exact_tile_launches - exact
    _log(f"{phase}: {t * 1e3:.4f} ms an application, busy share {out['busy_share']}")
    return out


def run(d: int = 5, m_d: int = 32, device=None) -> dict:
    """The three phases on ``device`` (the card unless ``"cpu"``), as the
    JSON record the command prints."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: bench runs on the card by default; pass --device cpu to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    m = m_d**d
    with torch.no_grad():
        factors = bench_factors(d, m_d, device)
        v = bench_vector(m, device)
        card = torch.cuda.get_device_name(device) if v.is_cuda else "cpu"
        _log(f"device {card}, d={d}, m_d={m_d}, M={m}")

        step, route = matvec_step(factors, v)
        mv = _measure("matvec", step, v)
        mv_err = _rel_err(step(v), factors, v)
        _check_err("matvec", mv_err, "default")

        # A host scalar: a 0-d tensor on the card would be a stride-0 input,
        # which keeps the elementwise kernel off its vectorized path.
        one = torch.tensor(1.0)
        st = _measure("stream", lambda y: torch.add(one, y, alpha=2.0), v)
        if v.is_cuda and (len(st["kernels"]) != 1 or sum(st["kernels"].values()) != SHORT + ITERS["stream"]):
            raise RuntimeError(f"bench: the stream chain launched {st['kernels']}, not one kernel an application")

        x3 = x3_step(factors, v)
        if isinstance(x3, str):
            x3_res, x3_err = None, x3
        else:
            x3_res = _measure("x3", x3, v)
            x3_err = _rel_err(x3(v), factors, v)
            _check_err("x3", x3_err, "highest")

    itemsize = v.element_size()
    passes = _plan(factors)[0] if route == "slab" else None
    nbytes = {"nominal_2dM": 2 * d * m * itemsize, "in_out": 2 * m * itemsize}
    # K2's passes move M elements in and out each: float32 at the ends, bf16
    # between the passes at "default" (kron_matvec_fast's mid_dtype), float32
    # at "highest".
    nbytes_passes = {"matvec": None if passes is None else m * (2 * itemsize + 2 * 2 * (passes - 1)),
                     "x3": None if x3_res is None else m * 2 * itemsize * passes}
    kron_gbs = nbytes["nominal_2dM"] / mv["s"] / 1e9
    stream_gbs = 2 * m * itemsize / st["s"] / 1e9
    target = TARGET_SHARE * stream_gbs

    def rates(res, phase):
        if res is None:
            return x3_err
        out = {k: b / res["s"] / 1e9 for k, b in nbytes.items()}
        out["passes"] = None if nbytes_passes[phase] is None else nbytes_passes[phase] / res["s"] / 1e9
        return out

    return {
        "metric": "kron_matvec_bandwidth",
        "value": kron_gbs,
        "unit": "GB/s",
        "vs_baseline": kron_gbs / target,
        "detail": {
            "shape": f"(kron {d}x{m_d}^2)·v, m={m}",
            "dtype": GRADE,
            "device": card,
            "route": route,
            "matvec_ms": mv["s"] * 1e3,
            "matvec_rel_err": mv_err,
            "matvec_rel_err_max": REL_ERR_MAX["default"],
            "x3_grade_GBs": x3_err if x3_res is None else nbytes["nominal_2dM"] / x3_res["s"] / 1e9,
            "x3_ms": x3_err if x3_res is None else x3_res["s"] * 1e3,
            "x3_rel_err": x3_err,
            "x3_rel_err_max": REL_ERR_MAX["highest"],
            "stream_GBs": stream_gbs,
            "stream_ms": st["s"] * 1e3,
            "target_GBs(0.7xstream)": target,
            "bytes": {**nbytes, "passes": nbytes_passes},
            "GBs": {"matvec": rates(mv, "matvec"), "x3": rates(x3_res, "x3")},
            "busy_share": {"matvec": mv["busy_share"], "stream": st["busy_share"],
                           "x3": None if x3_res is None else x3_res["busy_share"]},
            "kernels": {"matvec": mv["kernels"], "stream": st["kernels"],
                        "x3": None if x3_res is None else x3_res["kernels"]},
            "launches": {"matvec": mv["launches"], "x3": 0 if x3_res is None else x3_res["launches"],
                         "x3_exact_tile": 0 if x3_res is None else x3_res["exact_tile_launches"]},
        },
    }


def main(argv=()) -> int:
    """``bench [--d D] [--m_d M] [--device cpu]``: print the record as one
    JSON line; 2 on a usage error."""
    rest = list(argv)
    try:
        d = _option(rest, "--d", USAGE)
        m_d = _option(rest, "--m_d", USAGE)
        device = _option(rest, "--device", USAGE)
    except ValueError as e:
        print(e)
        return 2
    if rest:
        print(f"unexpected arguments {rest}\n{USAGE}")
        return 2
    try:
        d, m_d = int(d or 5), int(m_d or 32)
    except ValueError:
        print(f"--d and --m_d expect integers\n{USAGE}")
        return 2
    if d < 1 or m_d < 1:
        print(USAGE)
        return 2
    print(json.dumps(run(d, m_d, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
