"""Hyperparameter cotangents of the matrix-free Gram apply taken on the
program's kernel K10 per unit (per Adam step), as the program counts them
(counter ``gram_fused_grads``: one per K10 call, in the backward of a
differentiated apply on K9) in the traced window."""

from gpbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "gram_fused_grads")
