"""Share of its roofline of the lattice dual's WᵀW (K5), in percent."""

from gpbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "stencil")
