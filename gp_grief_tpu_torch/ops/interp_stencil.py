"""``WᵀW`` as a ``3^d``-offset lattice stencil (the lattice dual's hot loop).

Counterpart of ``gp_grief_tpu.ops.interp_stencil``.  ``(WᵀW)[c, c'] =
Σ_i w_c(x_i)·w_{c'}(x_i)`` is nonzero only when cells ``c, c'`` are corners
of a common data cell, i.e. ``c' − c ∈ {−1, 0, 1}^d`` in grid coordinates — at
most ``3^d`` flat-index offsets ``δ``.  With per-offset coefficient tables

    A_δ[c] = Σ_i w_c(x_i) · w_{c+δ}(x_i)            (host, once per model)

the apply is ``out[c] = Σ_δ A_δ[c] · v[c + δ]``: ``D ≤ 3^d`` shifted
multiply-adds over the lattice, independent of the kernel hyperparameters.
Cells where a flat shift would wrap across a dimension boundary have
``A_δ[c] = 0``.  The apply on the card is kernel K5,
:func:`gp_grief_tpu_torch.ops.cuda.stencil.wtw_stencil`;
:func:`stencil_apply_ref` is its plain version.

The tables are built on the host in float64 by ``bincount`` (the JAX
package's host path); its device build exists for a TPU runtime and has no
counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gp_grief_tpu_torch.ops.interp import CornerStream, InterpWeights, build_corner_stream
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["WtWStencil", "build_wtw_stencil", "make_wtw_stencil_op", "stencil_apply_ref", "wtw_stencil_bm"]

_stencil_span = _prof.site("gp_grief.stencil", "B", "M", "D")


class WtWStencil(NamedTuple):
    """Static stencil form of ``WᵀW`` (host-built, geometry-only).

    ``tables (D, M)``: coefficient rows, one per flat-index offset;
    ``deltas (D,)`` ascending flat shifts (a tuple, and ``delta_t`` the same
    as an int64 tensor on the tables' device); ``d0s (D,)`` each offset's
    leading-dimension component; ``shape`` the grid shape.  ``plans``: K5's
    launch plans by ``(B, itemsize)``, made by its wrapper at a stencil's
    first launch at that batch and kept here.
    """

    tables: torch.Tensor
    deltas: Tuple[int, ...]
    delta_t: torch.Tensor
    d0s: Tuple[int, ...]
    shape: Tuple[int, ...]
    plans: dict

    @property
    def M(self) -> int:
        return math.prod(self.shape)


def build_wtw_stencil(
    iw: InterpWeights,
    stream: CornerStream | None = None,
    *,
    dtype=None,
    device=None,
    max_table_bytes: int = 1 << 31,
) -> WtWStencil | None:
    """Host-side (NumPy, float64 accumulation) stencil build from a NumPy
    :class:`InterpWeights`; the tables move to ``device`` in ``dtype``
    (default: the weights' dtype).

    Returns ``None`` when the tables ``D·M·itemsize`` would exceed
    ``max_table_bytes`` or the pair enumeration ``4^d`` is unreasonable
    (d > 6); callers then apply ``Wᵀ(W v)`` through the interpolation plan.
    """
    d = len(iw.shape)
    if 4**d > 4096:  # d > 6: table count and build cost both explode
        return None
    st = stream if stream is not None else build_corner_stream(iw)
    M = math.prod(st.shape)
    consts = np.asarray(st.consts, np.int64)
    base_sorted = np.asarray(st.base_sorted, np.int64)
    w_sorted = np.asarray(st.w_pts_sorted)
    nc = consts.shape[0]
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, w_sorted.dtype)).dtype
    itemsize = torch.empty(0, dtype=dtype).element_size()
    d_eff = sum(1 for m in iw.shape if m >= 2)
    if 3**d_eff * M * itemsize > max_table_bytes:
        return None

    offs = [tuple((k >> (d - 1 - dd)) & 1 for dd in range(d)) for k in range(nc)]
    off0 = np.asarray([o[0] if iw.shape[0] >= 2 else 0 for o in offs], np.int64)
    nonzero_k = [bool(np.any(w_sorted[k])) for k in range(nc)]
    # (WᵀW)ᵀ = WᵀW ⟹ A_{-δ}[c] = A_δ[c−δ]: only pairs with δ ≥ 0 are
    # accumulated; each negative table is a zero-filled right shift.
    pairs = [
        (k, kp, int(consts[kp] - consts[k]), int(off0[kp] - off0[k]))
        for k in range(nc) if nonzero_k[k]
        for kp in range(nc) if nonzero_k[kp] and consts[kp] >= consts[k]
    ]
    d0_of: dict = {}
    for _, _, delta, d0 in pairs:
        d0_of.setdefault(delta, d0)
        d0_of.setdefault(-delta, -d0)
    acc: dict = {}
    for k, kp, delta, _ in pairs:
        wprod = (w_sorted[k] * w_sorted[kp]).astype(np.float64)
        if not np.any(wprod):
            continue
        tab = np.bincount(base_sorted + consts[k], weights=wprod, minlength=M)
        if delta in acc:
            acc[delta] += tab
        else:
            acc[delta] = tab
    for delta in list(acc):
        if delta > 0:
            acc[-delta] = np.concatenate([np.zeros(delta), acc[delta][: M - delta]])
    deltas = sorted(dl for dl, tab in acc.items() if np.any(tab))
    if not deltas:  # n == 0
        deltas = [0]
        acc[0] = np.zeros(M)
        d0_of[0] = 0
    tables = torch.as_tensor(np.stack([acc[dl] for dl in deltas])).to(device=device, dtype=dtype)
    return WtWStencil(
        tables=tables.contiguous(),
        deltas=tuple(int(dl) for dl in deltas),
        delta_t=torch.as_tensor(deltas, dtype=torch.int64, device=device),
        d0s=tuple(int(d0_of[dl]) for dl in deltas),
        shape=tuple(st.shape),
        plans={},
    )


def stencil_apply_ref(st: WtWStencil, v_bm: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: pad ``v`` with zeros and add the ``D`` shifted
    products in offset order."""
    M = st.M
    S = max(1, max(abs(dl) for dl in st.deltas))
    vp = torch.nn.functional.pad(v_bm, (S, S))
    out = torch.zeros_like(v_bm)
    for i, dl in enumerate(st.deltas):
        out = out + st.tables[i][None, :] * vp[:, S + dl : S + dl + M]
    return out


def wtw_stencil_bm(st: WtWStencil, v_bm: torch.Tensor) -> torch.Tensor:
    """Apply ``WᵀW`` to batch-major lattice vectors ``(B, M) → (B, M)``
    through kernel K5 (its plain version for CPU tensors).  Differentiable:
    the backward is the same stencil (``WᵀW`` is symmetric)."""
    from gp_grief_tpu_torch.ops.cuda.stencil import wtw_stencil

    return wtw_stencil(st, v_bm)


def make_wtw_stencil_op(st: WtWStencil):
    """Closure form of :func:`wtw_stencil_bm` for solver plumbing, each
    apply spanned as ``gp_grief.stencil``."""
    D = len(st.deltas)

    def wtw(v_bm):
        with _stencil_span(int(v_bm.shape[0]), int(v_bm.shape[1]), D):
            return wtw_stencil_bm(st, v_bm)

    return wtw
