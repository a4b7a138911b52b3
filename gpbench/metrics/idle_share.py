"""The device's idle share of the traced window's work, in percent: one
minus the union of its operations' intervals in the traced window over the
time the same units take untraced (the profiler's host cost slows the
host-paced cells' window about 2.5 times, which would read as idle)."""


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0.0 or ctx["untraced_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / ctx["untraced_s"])
