"""CG iterations per unit as the program counts them (counter
``cg_iterations``: every iteration its solvers ran, in the traced window);
for a request, both of ``predict``'s solves."""

from gpbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "cg_iterations")
