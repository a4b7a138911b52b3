"""Per-layer metric readers, one module per metric family, found by the
part of a per-layer metric's name before its first dot
(``kron_roofline.train`` → ``metrics/kron_roofline.py``).

Each module has ``read(ctx) -> float | None``; ``None`` means the run holds
nothing for it to read, and the harness leaves the metric out of the line.
``ctx`` (built by ``gpbench.run``) holds:

- ``profile``: :func:`gpbench.trace.reduce_profile`'s summary of the traced
  window (``window_s``, ``busy_s``, ``span_device_s``, …);
- ``calls``: the traced window's operator calls by span kind, each a
  :class:`gpbench.counts.Cost`; ``shapes``: their ``(batch, length)``;
- ``apply_span``: the span kind that marks one solver-operator apply;
- ``units``: the traced window's units (``steps``, ``cg_iterations``);
- ``untraced_s``: the seconds those units take when run again untraced.
"""


def roofline(ctx, kind: str):
    """Percent: the counted least time of every ``kind`` call in the traced
    window over the device time of the kernels those calls launched."""
    calls = ctx["calls"].get(kind)
    dev = ctx["profile"]["span_device_s"].get(kind, 0.0)
    if not calls or dev <= 0.0:
        return None
    return 100.0 * sum(c.seconds for c in calls) / dev
