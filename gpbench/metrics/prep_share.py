"""Percent of a ``predict`` request's host time spent in its per-call
precomputation: the program's ``gp_grief.model.predict.prep`` span (the
mean solve, redone every request) over ``gp_grief.model.predict``'s, in the
traced window."""

from gpbench.spans import span


def read(ctx):
    prep, whole = span("gp_grief.model.predict.prep"), span("gp_grief.model.predict")
    if prep is None or whole is None or whole["host_s"] <= 0.0:
        return None
    return 100.0 * prep["host_s"] / whole["host_s"]
