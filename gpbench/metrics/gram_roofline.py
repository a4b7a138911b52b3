"""Share of its roofline of the matrix-free Gram apply (cuBLAS and ATen kernels), in percent."""

from gpbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "gram")
