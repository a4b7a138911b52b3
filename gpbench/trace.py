"""Spans around the program's operator entry points, and the reduction of a
``torch.profiler`` trace to the numbers the per-layer readers take.

The program carries no spans of its own yet, so a traced run replaces each
operator entry point at every name the models reach it by with a wrapper
from this file.  The wrapper opens a ``record_function`` span named
``gpbench.<kind>`` and records the call's shapes; the device kernels a call
launches are attributed to its span through the profiler's correlation of
each kernel with the host call that launched it.  Untraced runs install
nothing.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from gpbench import counts

__all__ = ["Recorder", "install", "reduce_profile"]



@dataclass
class Recorder:
    """The calls of the traced window: ``calls[kind]`` is a list of
    :class:`gpbench.counts.Cost`, ``shapes[kind]`` the ``(batch, length)`` of
    each call."""

    on: bool = False
    calls: dict = field(default_factory=lambda: defaultdict(list))
    shapes: dict = field(default_factory=lambda: defaultdict(list))

    @contextmanager
    def span(self, kind: str, cost_fn):
        if not self.on:
            yield
            return
        cost, shape = cost_fn()
        self.calls[kind].append(cost)
        self.shapes[kind].append(shape)
        with torch.profiler.record_function("gpbench." + kind):
            yield


def _kron_cost(factors, v, precision):
    lead = 1
    fs = list(factors)
    if len(fs) > 1 and getattr(fs[0], "kron_batch_identity", False):
        lead = int(fs[0].shape[0])
        fs = fs[1:]
    sizes = [int(f.shape[0]) for f in fs]
    cols = int(v.shape[1]) if v.ndim == 2 else 1
    fast = precision == "default" or precision is None or v.dtype == torch.bfloat16
    c = counts.kron(lead * cols, sizes, v.element_size(), fast=fast, out_itemsize=4 if v.element_size() == 2 else 0)
    return c, (lead * cols, math.prod(sizes))


_WRAPPED = (("gp_ski", "kron_matvec_fast"), ("gp_ski", "interp_wt"), ("gp_ski", "interp_w"),
            ("gp_ski", "make_wtw_stencil_op"), ("gp_regression", "make_gram_matvec"))


def install(rec: Recorder):
    """Wrap the operator entry points at the names the models call them by:
    the Kronecker matvec, ``Wᵀ`` and ``W`` and the ``WᵀW`` stencil in
    ``models.gp_ski``, and the matrix-free Gram apply in
    ``models.gp_regression``.  Returns a function that puts the originals
    back."""
    from gp_grief_tpu_torch.models import gp_ski, gp_regression

    mods = {"gp_ski": gp_ski, "gp_regression": gp_regression}
    saved = [(mods[m], n, getattr(mods[m], n)) for m, n in _WRAPPED]

    kron = gp_ski.kron_matvec_fast

    def kron_matvec_fast(factors, v, **kw):
        with rec.span("kron", lambda: _kron_cost(factors, v, kw.get("precision", "highest"))):
            return kron(factors, v, **kw)

    wt, w = gp_ski.interp_wt, gp_ski.interp_w

    def _interp(plan, B, itemsize):
        corners = 2 ** len(plan.shape)
        return counts.interp(B, plan.n, plan.M, corners, itemsize), (B, plan.M)

    def interp_wt(plan, u_bm):
        with rec.span("interp", lambda: _interp(plan, int(u_bm.shape[0]), u_bm.element_size())):
            return wt(plan, u_bm)

    def interp_w(plan, v_bm):
        with rec.span("interp", lambda: _interp(plan, int(v_bm.shape[0]), v_bm.element_size())):
            return w(plan, v_bm)

    make_stencil = gp_ski.make_wtw_stencil_op

    def make_wtw_stencil_op(st):
        op = make_stencil(st)
        D = len(st.deltas)

        def wtw(v_bm):
            B = int(v_bm.shape[0])
            with rec.span("stencil", lambda: (counts.stencil(B, st.M, D, v_bm.element_size()), (B, st.M))):
                return op(v_bm)

        return wtw

    make_gram = gp_regression.make_gram_matvec

    def make_gram_matvec(kernels, x, sigma2, *, chunk, precision="highest"):
        mv = make_gram(kernels, x, sigma2, chunk=chunk, precision=precision)
        n, dim = int(x.shape[0]), int(x.shape[1])

        def gram(vv):
            B = int(vv.shape[0])
            with rec.span("gram", lambda: (counts.gram(B, n, dim, x.element_size()), (B, n))):
                return mv(vv)

        return gram

    gp_ski.kron_matvec_fast = kron_matvec_fast
    gp_ski.interp_wt, gp_ski.interp_w = interp_wt, interp_w
    gp_ski.make_wtw_stencil_op = make_wtw_stencil_op
    gp_regression.make_gram_matvec = make_gram_matvec

    def uninstall():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return uninstall


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def reduce_profile(prof) -> dict:
    """From the profiler's in-memory events, over the ``gpbench.window``
    span: its length, the union of device-operation intervals within it, the
    device seconds of the kernels inside each span kind's device-side range
    (the profiler draws one over the kernels each ``gpbench.<kind>`` span
    launched), the device operations that took most time, and what the host
    was doing during the idle gaps."""
    evs = prof.profiler.kineto_results.events()
    dev, ranges, host = [], [], []
    win = None
    for e in evs:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if _is_device(e):
            if name.startswith("gpbench."):
                if name != "gpbench.window":
                    ranges.append((s, s + d, name[8:]))
            else:
                dev.append((s, s + d, name))
            continue
        if name == "gpbench.window":
            win = (s, s + d)
        host.append((s, s + d, name))
    if win is None:
        raise RuntimeError("the trace holds no gpbench.window span")
    w0, w1 = win
    dev = sorted((max(s, w0), min(e, w1), name) for s, e, name in dev if e > w0 and s < w1)
    # Union of device intervals, and the gaps between them.
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = defaultdict(int)
    for s, e, name in dev:
        by_name[name] += e - s
    # Kernel time by the span kind whose device-side range holds it (the
    # ranges of one stream do not overlap).
    ranges.sort()
    rstarts = [r[0] for r in ranges]
    span_dev = defaultdict(int)
    held = 0
    for s, e, _ in dev:
        i = bisect.bisect_right(rstarts, s) - 1
        if i >= 0 and e <= ranges[i][1]:
            span_dev[ranges[i][2]] += e - s
            held += 1
    # What the host was doing in the longest idle gaps: the innermost host
    # event around each gap's middle.
    host.sort()
    hstarts = [h[0] for h in host]
    idle = defaultdict(int)
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:4000]:
        mid = (gs + ge) // 2
        i = bisect.bisect_right(hstarts, mid) - 1
        name = "(no host event)"
        for j in range(i, max(-1, i - 400), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += ge - gs

    def top(d):
        return [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9, "device_ops": top(by_name), "idle_gaps": top(idle),
            "span_device_s": {k: v * 1e-9 for k, v in span_dev.items()}, "kernels": len(dev), "in_spans": held}
