"""Percent of a GP-GRIEF iterative NLML's host time spent before its solver
starts: the program's ``gp_grief.grief.prep`` span (the cache refresh, Φ,
the low-rank factor and its whitening check, rebuilt at every new point)
over ``gp_grief.model.nlml``'s, in the traced window."""

from gpbench.spans import span


def read(ctx):
    prep, whole = span("gp_grief.grief.prep"), span("gp_grief.model.nlml")
    if prep is None or whole is None or whole["host_s"] <= 0.0:
        return None
    return 100.0 * prep["host_s"] / whole["host_s"]
