"""Profiling helpers: ``torch.profiler`` traces, wall-clock spans, and the
program's own spans and counters.

Counterpart of ``gp_grief_tpu.utils.profiling``.  :func:`trace` records the
enclosed region (host, and the card's kernels when CUDA is available) and
writes a Chrome trace into a directory; :func:`timed` wall-clocks a region,
synchronizing the card before and after when CUDA is in use.

The port's own instrumentation (the port's addition) records only while a
``torch.profiler`` is recording, and costs one flag check otherwise:

- :func:`site` (a span site: its name and attribute names bound once, the
  form of the program's own sites), :func:`span` (a one-off context
  manager) and :func:`spanned` (the decorator form) mark a region
  ``gp_grief.<layer>...`` as a host event at the profiler's ``FUNCTION``
  scope, on the profiler's clock.  ``FUNCTION`` scope draws no
  device-side range over the kernels the region launches (a
  ``record_function`` range, ``USER_SCOPE``, would, and would take those
  kernels from any enclosing user range).  A span's attributes reach the
  trace's ``kwinputs`` when the profiler records shapes.
- The span of a model entry point (an NLML, a ``predict`` request, an Adam
  step; ``entry=True``) draws a fresh call id, which every span opened
  inside it carries as its ``call`` attribute.
- :func:`count` adds to a named counter; :func:`host_read` is the span of
  one synchronising device-to-host read, counted in ``host_reads``.
- :func:`snapshot` returns what was recorded since the process started or
  since :func:`reset`: per span name its calls, host seconds and self
  seconds (less its child spans'), and the counters.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled as _enabled
from torch._C._profiler import _RecordFunctionFast

__all__ = ["trace", "timed", "site", "span", "spanned", "count", "host_read", "snapshot", "reset"]


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


# Per span name [calls, host ns, self ns]; per counter name its total.  The
# lock orders updates from two threads (a CUDA backward runs spans on the
# autograd engine's thread).
_SPANS: dict = {}
_COUNTERS: dict = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()
_CALL_IDS = itertools.count(1)


class _Off:
    """The span of a call made while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "entry", "call", "rf", "child", "t0")

    def __init__(self, name: str, attrs: dict, entry: bool):
        self.name, self.attrs, self.entry = name, attrs, entry

    def __enter__(self):
        st = _stack()
        self.call = next(_CALL_IDS) if self.entry else (st[-1].call if st else None)
        attrs = self.attrs
        if self.call is not None:
            attrs["call"] = self.call
        # keyword_values must be a dict when given: None aborts the process.
        self.rf = _RecordFunctionFast(self.name, keyword_values=attrs) if attrs else _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.child = 0
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        st = _stack()
        st.pop()
        if st:
            st[-1].child += dt
        with _LOCK:
            agg = _SPANS.get(self.name)
            if agg is None:
                agg = _SPANS[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.child
        return None


def site(name: str, *keys: str, entry: bool = False):
    """A span site, its name (``gp_grief.<layer>...``) and attribute names
    bound once: ``kron_span = site("gp_grief.kron", "route", "B")`` at
    import, then ``with kron_span(route, B):`` per call, the values str,
    int, float or bool.  While no profiler records, a call is one flag check
    that returns a shared no-op (and, unlike :func:`span`'s keywords, builds
    no dict).  ``entry``: a model entry point's span, which takes a fresh
    call id."""

    def open_span(*values):
        if not _enabled():
            return _OFF
        return _Span(name, dict(zip(keys, values)), entry)

    return open_span


def span(name: str, **attrs):
    """A one-off span named ``name`` over the ``with`` block, with ``attrs``
    as its attributes; a shared no-op while no profiler records."""
    if not _enabled():
        return _OFF
    return _Span(name, attrs, False)


def spanned(name: str, *, entry: bool = False):
    """Decorator form of :func:`site` (no attributes) over each call of the
    function."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with _Span(name, {}, entry):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _enabled():
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def host_read(where: str, n: int = 1):
    """The span ``gp_grief.host_read`` (attribute ``site``) of ``n``
    synchronising device-to-host reads at ``where``, counted in
    ``host_reads``."""
    if not _enabled():
        return _OFF
    count("host_reads", n)
    return _Span("gp_grief.host_read", {"site": where}, False)


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "host_s", "self_s"}}, "counters": {name:
    n}}``: what was recorded since the process started or :func:`reset`.
    Host seconds are the host clock's, the profiler's overhead included."""
    with _LOCK:
        return {"spans": {k: {"calls": c, "host_s": h * 1e-9, "self_s": s * 1e-9}
                          for k, (c, h, s) in _SPANS.items()}, "counters": dict(_COUNTERS)}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
