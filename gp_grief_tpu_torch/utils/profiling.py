"""Profiling helpers: ``torch.profiler`` traces and wall-clock spans.

Counterpart of ``gp_grief_tpu.utils.profiling``.  :func:`trace` records the
enclosed region (host, and the card's kernels when CUDA is available) and
writes a Chrome trace into a directory; :func:`timed` wall-clocks a region,
synchronizing the card before and after when CUDA is in use.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "timed"]


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed region into ``logdir/trace_<pid>_<ns>.json``
    (Chrome trace format; ``chrome://tracing`` or Perfetto read it)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
        if _cuda_in_use():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    """Wall-clock the enclosed region into ``results[label]`` (seconds), or
    print it.  With CUDA in use the card is synchronized before and after,
    so the span covers the device work the region enqueued."""
    if _cuda_in_use():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if _cuda_in_use():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[timed] {label}: {dt:.4f}s")
