"""The program's own spans and counters of a traced window, for the
per-layer readers that take them (``metrics/host_reads.py``,
``solver_iters.py``, ``kron_host_us.py``, ``prep_share.py``).

The program (``gp_grief_tpu_torch.utils.profiling``) records its spans and
counters only while a ``torch.profiler`` records, so in a run of
``gpbench.run`` its :func:`snapshot` holds the traced window and nothing
else.  Where the program keeps none (a version without them), every reader
here returns ``None`` and the harness leaves the metric out of the line.
"""

from __future__ import annotations


def snapshot():
    """The program's ``profiling.snapshot()``, or ``None`` where it has none."""
    from gp_grief_tpu_torch.utils import profiling

    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def per_unit(ctx, counter: str):
    """Counter ``counter`` over the traced window's units (their steps)."""
    snap = snapshot()
    steps = sum(u["steps"] for u in ctx["units"])
    if snap is None or counter not in snap["counters"] or steps <= 0:
        return None
    return snap["counters"][counter] / steps


def span(name: str):
    """Span ``name``'s ``{"calls", "host_s", "self_s"}``, or ``None`` where
    it was not recorded."""
    snap = snapshot()
    s = None if snap is None else snap["spans"].get(name)
    return s if s and s["calls"] > 0 else None
