"""Lazy linear-operator composition: products and sums of matvec closures.

Counterpart of ``gp_grief_tpu.ops.compose``.  An operator is its matvec
closure, so composition is function composition; these helpers build solver
operands from structured pieces without densifying.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["op_product", "op_sum", "op_scale", "op_shift"]

MatVec = Callable[[torch.Tensor], torch.Tensor]


def op_product(ops: Sequence[MatVec]) -> MatVec:
    """``(A_1 · A_2 · … · A_k) v``: the matvecs applied right to left."""
    ops = list(ops)

    def mv(v):
        for op in reversed(ops):
            v = op(v)
        return v

    return mv


def op_sum(ops: Sequence[MatVec]) -> MatVec:
    """``(A_1 + … + A_k) v``."""
    ops = list(ops)

    def mv(v):
        out = None
        for op in ops:
            out = op(v) if out is None else out + op(v)
        return out

    return mv


def op_scale(op: MatVec, c) -> MatVec:
    """``(c·A) v``."""
    return lambda v: c * op(v)


def op_shift(op: MatVec, c) -> MatVec:
    """``(A + c·I) v``: the noise-shifted operator."""
    return lambda v: op(v) + c * v
