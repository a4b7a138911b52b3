"""Share of its roofline of the Kronecker matvec (K2, or whatever implements it), in percent."""

from gpbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "kron")
