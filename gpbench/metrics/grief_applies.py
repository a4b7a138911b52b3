"""Applies of GP-GRIEF's whitened operator per unit (per NLML), as the
program counts them (counter ``grief_applies``: one per solver apply of
``GPGriefModel.log_likelihood_iterative_segmented``, any row count) in the
traced window."""

from gpbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "grief_applies")
