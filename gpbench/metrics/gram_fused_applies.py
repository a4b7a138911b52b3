"""Matrix-free Gram applies run on the program's fused kernel K9 per unit
(per Adam step), as the program counts them (counter
``gram_fused_applies``: one per solver-role apply on K9) in the traced
window."""

from gpbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "gram_fused_applies")
