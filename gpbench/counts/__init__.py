"""Operations and bytes of each operator call, as functions of its shapes.

Each count is of the function's work, not of the kernel that runs it: every
input byte is read once and every output byte written once, and the
operations are those the mathematics needs.  So a roofline share reads the
same work whatever implements the call, and cannot pass 100% unless the time
leaves out part of the work.  A call's least time is the larger of its bytes
over the card's memory rate and its operations over the peak of its grade.

Peaks are NVIDIA's published dense rates of one H100 SXM at 700 W: HBM3
3.35 TB/s; bf16 989 TFLOP/s; TF32 495 TFLOP/s, so an exact float32 product
emulated by three TF32 products (the "highest" and X3 grades of the
Kronecker matvec) 495/3; float32 outside the tensor cores 67 TFLOP/s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

__all__ = ["PEAK_BYTES_S", "PEAK_FLOPS", "Cost", "kron", "stencil", "interp", "gram", "cg_update"]

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32x3": 495e12 / 3, "fp32": 67e12, "fp64": 67e12}


class Cost(NamedTuple):
    flops: float
    bytes: float
    grade: str

    @property
    def seconds(self) -> float:
        """The least time: bytes at the memory rate or operations at the
        grade's peak, whichever is longer."""
        return max(self.bytes / PEAK_BYTES_S, self.flops / PEAK_FLOPS[self.grade])


def _grade(itemsize: int, fast: bool) -> str:
    if itemsize == 8:
        return "fp64"
    return "bf16" if fast or itemsize == 2 else "fp32x3"


def kron(lead: int, sizes, itemsize: int, *, fast: bool = False, out_itemsize: int = 0) -> Cost:
    """``(I_lead ⊗ K_1 ⊗ … ⊗ K_d) v`` with square ``m_d × m_d`` factors:
    ``2·m_d`` operations per element per factor, the vector read once and
    the result written once (the factors are a few KB).  ``fast``: the bf16
    grade."""
    elems = lead * math.prod(sizes)
    flops = 2.0 * elems * sum(sizes)
    nbytes = elems * (itemsize + (out_itemsize or itemsize)) + sum(m * m * 4 for m in sizes)
    return Cost(flops, float(nbytes), _grade(itemsize, fast))


def stencil(batch: int, lattice: int, offsets: int, itemsize: int) -> Cost:
    """``WᵀW v`` in its banded form: ``offsets`` coefficient rows of the
    lattice's length (the operator itself, read once), the ``(B, M)`` input
    read and output written once; two operations per coefficient and row."""
    flops = 2.0 * batch * lattice * offsets
    nbytes = (offsets + 2 * batch) * lattice * itemsize
    return Cost(flops, float(nbytes), "fp32" if itemsize == 4 else "fp64")


def interp(batch: int, points: int, lattice: int, corners: int, itemsize: int) -> Cost:
    """``Wᵀu`` ``(B, n) → (B, M)`` or ``Wv`` ``(B, M) → (B, n)`` with
    ``corners`` weights per point: the weights and their int32 indices read
    once, the input read and the output written once."""
    flops = 2.0 * batch * points * corners
    nbytes = points * corners * (itemsize + 4) + batch * (points + lattice) * itemsize
    return Cost(flops, float(nbytes), "fp32" if itemsize == 4 else "fp64")


def gram(batch: int, points: int, dim: int, itemsize: int) -> Cost:
    """One matrix-free apply ``vv ↦ vv (K + σ²I)``, ``vv`` ``(B, n)``: ``n²``
    kernel entries at ``2·dim`` operations of distance and 8 more (scale,
    snap, the exponential as one, the variance), then ``2B`` of contraction,
    at the float32 rate (TF32 is off); ``x``, ``vv`` and the output once."""
    flops = float(points) * points * (2 * dim + 8 + 2 * batch)
    nbytes = points * dim * itemsize + 2 * batch * points * itemsize
    return Cost(flops, float(nbytes), "fp32" if itemsize == 4 else "fp64")


def cg_update(batch: int, length: int, itemsize: int) -> Cost:
    """A solver's vector work around one operator apply: ``x``, ``r``, ``p``
    and the apply's output read once, ``x``, ``r`` and ``p`` written once
    (the two inner products read what the update reads)."""
    elems = batch * length
    return Cost(10.0 * elems, 7.0 * elems * itemsize, "fp32" if itemsize == 4 else "fp64")
