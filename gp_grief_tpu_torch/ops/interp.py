"""Grid interpolation operators (SKI-style sparse Khatri-Rao weights).

Counterpart of ``gp_grief_tpu.ops.interp``.  Scattered points are tied to a
Cartesian grid by a sparse interpolation matrix ``W`` whose row ``i``
factorizes over dimensions, ``W[i] = ⊗_d w_d(x_i)``, each ``w_d`` holding two
non-zeros (linear interpolation between the bracketing grid points).
``W @ v`` interpolates grid values to the points; ``Wᵀ @ u`` spreads point
values onto the grid corners.

Two representations of the same weights:

* :class:`InterpWeights` of NumPy arrays (:func:`interp_weights` on a NumPy
  ``x``) feeds the host-side plan construction (:func:`build_corner_stream`,
  :func:`build_interp_plan`, ``ops.interp_stencil.build_wtw_stencil``);
* :class:`InterpWeights` of tensors (:func:`interp_weights` on a tensor,
  ``torch.searchsorted`` on its device) serves test points and the
  per-dimension projections of the deflation basis.

The transpose ``Wᵀ`` of the solvers' hot loop is kernel K4,
:func:`gp_grief_tpu_torch.ops.cuda.interp.interp_wt`, over the cell-sorted
stream an :class:`InterpPlan` holds; :func:`interp_rmatvec_bm_exact` is its
plain version.  The JAX package's one-hot tile layout (``OneHotPlan``) is the
TPU's operand layout for a matrix-unit dot and has no counterpart here.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "InterpWeights",
    "InterpPlan",
    "CornerStream",
    "interp_weights",
    "iw_to_torch",
    "build_corner_stream",
    "build_interp_plan",
    "interp_matvec",
    "interp_rmatvec",
    "interp_matvec_bm",
    "interp_rmatvec_bm",
    "interp_matvec_bm_fast",
    "interp_rmatvec_bm_fast",
    "interp_rmatvec_bm_exact",
    "interp_expand",
]


class InterpWeights(NamedTuple):
    """Per-dimension linear-interpolation data for ``n`` points on a grid.

    ``idx[d]``: ``(n,)`` — left bracketing grid index in dim ``d`` (int32 for
    NumPy, int64 for tensors); ``w[d]``: ``(n, 2)`` — weights of the (left,
    right) grid points; ``shape``: the grid shape ``(m_1, ..., m_d)``.
    """

    idx: Tuple
    w: Tuple
    shape: Tuple[int, ...]


def interp_weights(x, xg: Sequence) -> InterpWeights:
    """Linear interpolation weights of points ``x`` (n, d) on grid ``xg``.

    Points outside the grid clamp to the boundary cell (constant
    extrapolation of the cell's linear model); a degenerate ``m_d = 1``
    dimension puts all mass on its single point.  A tensor ``x`` is handled
    on its device with ``torch.searchsorted`` (``xg`` tensors on the same
    device); a NumPy ``x`` on the host with NumPy, for building plans.
    Both clamp identically: ``side="right"``, ``left ∈ [0, m − 2]``.
    """
    if not isinstance(x, torch.Tensor):
        return _interp_weights_np(x, xg)
    if x.ndim == 1:
        x = x[:, None]
    idxs, ws = [], []
    for d, g in enumerate(xg):
        gd = g.reshape(-1).to(x.dtype).contiguous()
        m = gd.shape[0]
        xi = x[:, d].contiguous()
        if m == 1:
            idxs.append(torch.zeros(xi.shape, dtype=torch.int64, device=x.device))
            ws.append(torch.stack([torch.ones_like(xi), torch.zeros_like(xi)], dim=1))
            continue
        left = torch.clamp(torch.searchsorted(gd, xi, right=True) - 1, 0, m - 2)
        g0 = gd[left]
        g1 = gd[left + 1]
        span = g1 - g0
        t = torch.clamp((xi - g0) / torch.where(span > 0, span, torch.ones_like(span)), 0.0, 1.0)
        idxs.append(left)
        ws.append(torch.stack([1.0 - t, t], dim=1))
    return InterpWeights(idx=tuple(idxs), w=tuple(ws), shape=tuple(int(g.shape[0]) for g in xg))


def _interp_weights_np(x, xg) -> InterpWeights:
    """Host-NumPy :func:`interp_weights` (same math, same clamping)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    idxs, ws = [], []
    for d, g in enumerate(xg):
        gd = np.asarray(g).reshape(-1)
        m = gd.shape[0]
        xi = x[:, d]
        if m == 1:
            idxs.append(np.zeros(xi.shape, np.int32))
            ws.append(np.stack([np.ones_like(xi), np.zeros_like(xi)], axis=1).astype(x.dtype))
            continue
        left = np.clip(np.searchsorted(gd, xi, side="right") - 1, 0, m - 2)
        g0 = gd[left]
        g1 = gd[left + 1]
        span = g1 - g0
        t = np.clip((xi - g0) / np.where(span > 0, span, 1.0), 0.0, 1.0)
        idxs.append(left.astype(np.int32))
        ws.append(np.stack([1.0 - t, t], axis=1).astype(x.dtype))
    return InterpWeights(idx=tuple(idxs), w=tuple(ws), shape=tuple(int(np.asarray(g).shape[0]) for g in xg))


def iw_to_torch(iw: InterpWeights, *, dtype, device) -> InterpWeights:
    """Tensor copy of a NumPy :class:`InterpWeights` (int64 indices)."""
    return InterpWeights(
        idx=tuple(torch.as_tensor(np.asarray(i), dtype=torch.int64, device=device) for i in iw.idx),
        w=tuple(torch.as_tensor(np.asarray(w), dtype=dtype, device=device) for w in iw.w),
        shape=tuple(iw.shape),
    )


def _corners(iw: InterpWeights):
    """``(flat index (n,), weight (n,))`` of each of the ``2^d`` corner
    combinations.  Corner indices clip to the dimension bound, so phantom
    corners of degenerate (``m_d = 1``) dimensions, whose weight is exactly
    zero, cannot bleed into neighbouring flat indices."""
    d = len(iw.shape)
    for offsets in itertools.product((0, 1), repeat=d):
        yield _corner_flat_idx(iw, offsets), _corner_weight(iw, offsets)


def _corner_flat_idx(iw: InterpWeights, offsets) -> torch.Tensor:
    """Flat C-order grid index of one corner combination ``(n,)``."""
    flat = None
    for d, (left, off) in enumerate(zip(iw.idx, offsets)):
        comp = torch.clamp(left + off, max=iw.shape[d] - 1)
        flat = comp if flat is None else flat * iw.shape[d] + comp
    return flat


def _corner_weight(iw: InterpWeights, offsets) -> torch.Tensor:
    weight = None
    for dd, off in enumerate(offsets):
        wd = iw.w[dd][:, off]
        weight = wd if weight is None else weight * wd
    return weight


def interp_matvec(iw: InterpWeights, v_grid: torch.Tensor) -> torch.Tensor:
    """``W @ v``: ``v`` ``(M,)`` or ``(M, B)`` → ``(n,)`` / ``(n, B)``."""
    squeeze = v_grid.ndim == 1
    vv = v_grid[:, None] if squeeze else v_grid
    out = None
    for flat, weight in _corners(iw):
        contrib = weight[:, None] * vv[flat]
        out = contrib if out is None else out + contrib
    return out[:, 0] if squeeze else out


def interp_rmatvec(iw: InterpWeights, u: torch.Tensor) -> torch.Tensor:
    """``Wᵀ @ u``: scatter point values onto grid corners, ``(M,)`` /
    ``(M, B)``.  ``index_add_`` sums colliding updates with atomics on CUDA
    (order unspecified); the solvers use K4 instead."""
    M = math.prod(iw.shape)
    squeeze = u.ndim == 1
    uu = u[:, None] if squeeze else u
    out = torch.zeros((M, uu.shape[1]), dtype=uu.dtype, device=uu.device)
    for flat, weight in _corners(iw):
        out.index_add_(0, flat, weight[:, None] * uu)
    return out[:, 0] if squeeze else out


def interp_matvec_bm(iw: InterpWeights, v_grid_bm: torch.Tensor) -> torch.Tensor:
    """Batch-major ``W @ v``: ``v`` ``(B, M)`` → ``(B, n)``."""
    out = None
    for flat, weight in _corners(iw):
        contrib = weight[None, :] * v_grid_bm[:, flat]
        out = contrib if out is None else out + contrib
    return out


def interp_rmatvec_bm(iw: InterpWeights, u_bm: torch.Tensor) -> torch.Tensor:
    """Batch-major ``Wᵀ @ u``: ``u`` ``(B, n)`` → ``(B, M)``.

    Serves the test-point rows ``Wᵀ·I_c`` of predict: there each row of the
    output receives each cell from one point at most (the other terms are
    exact zeros), so the indexed add is deterministic on every device."""
    M = math.prod(iw.shape)
    out = torch.zeros((u_bm.shape[0], M), dtype=u_bm.dtype, device=u_bm.device)
    for flat, weight in _corners(iw):
        out.index_add_(1, flat, weight[None, :] * u_bm)
    return out


class CornerStream(NamedTuple):
    """Shared host-side (NumPy) corner-update stream; built once per model.

    Counterpart of ``gp_grief_tpu.ops.interp.CornerStream``: the multiset of
    ``2^d·n`` (corner cell, weight, point) updates every plan starts from.
    Every corner's flat index is exactly ``base + consts[k]`` (``left`` is
    clamped to ``m_d − 2`` and degenerate dimensions contribute index 0 at
    weight 0), so after one ``n``-element sort of ``base`` each corner's
    stream is already sorted by cell, and per-cell ranks follow from counting.

    Fields (``L = Σ_k nnz_k`` after zero-weight pruning): ``base (n,)``
    data-order base cells; ``consts (2^d,)``; ``perm/inv_perm (n,)`` the
    cell sort of the points and its inverse; ``base_sorted (n,)``;
    ``w_pts_sorted (2^d, n)`` per-corner weights in sorted-point order
    (unpruned); ``flat_u/w_u/src_u/rank_u (L,)`` the pruned stream in
    corner-major order — cell, weight, sorted-point id, rank within its cell;
    ``counts (M,)`` per-cell totals; ``tail`` (``tail[k-1] = #(rank ≥ k)``);
    ``shape``.
    """

    base: np.ndarray
    consts: np.ndarray
    perm: np.ndarray
    inv_perm: np.ndarray
    base_sorted: np.ndarray
    w_pts_sorted: np.ndarray
    flat_u: np.ndarray
    w_u: np.ndarray
    src_u: np.ndarray
    rank_u: np.ndarray
    counts: np.ndarray
    tail: np.ndarray
    shape: Tuple[int, ...]


def build_corner_stream(iw: InterpWeights) -> CornerStream:
    """Build the shared :class:`CornerStream` for a NumPy
    :class:`InterpWeights` (host NumPy, the JAX package's algorithm)."""
    d = len(iw.shape)
    M = math.prod(iw.shape)
    n = int(np.asarray(iw.idx[0]).shape[0])
    idx_h = [np.asarray(ix).astype(np.int64) for ix in iw.idx]
    w_h = [np.asarray(w) for w in iw.w]
    strides = np.ones(d, np.int64)
    for dd in range(d - 2, -1, -1):
        strides[dd] = strides[dd + 1] * iw.shape[dd + 1]
    smax = int(strides.sum())
    base64 = np.zeros(n, np.int64)
    for dd in range(d):
        base64 += idx_h[dd] * strides[dd]
    base = base64.astype(np.int32)
    offs = list(itertools.product((0, 1), repeat=d))
    consts = np.asarray(
        [sum(int(o[dd]) * int(strides[dd]) for dd in range(d) if iw.shape[dd] >= 2) for o in offs],
        np.int32,
    )
    perm = np.argsort(base, kind="stable").astype(np.int32)
    inv_perm = np.empty(n, np.int32)
    inv_perm[perm] = np.arange(n, dtype=np.int32)
    base_sorted = base[perm]
    ws_h = [w_h[dd][perm] for dd in range(d)]
    w_pts_sorted = np.empty((2**d, n), w_h[0].dtype)
    for k, o in enumerate(offs):
        w = ws_h[0][:, o[0]].copy()
        for dd in range(1, d):
            w *= ws_h[dd][:, o[dd]]
        w_pts_sorted[k] = w
    nz = w_pts_sorted != 0
    cnt_k = nz.sum(axis=1)
    L = int(cnt_k.sum())
    flat_u = np.empty(L, np.int32)
    w_u = np.empty(L, w_pts_sorted.dtype)
    src_u = np.empty(L, np.int32)
    rank_u = np.empty(L, np.int32)
    idxn = np.arange(n, dtype=np.int64)
    within0 = None
    if n:
        newseg0 = np.empty(n, bool)
        newseg0[0] = True
        np.not_equal(base_sorted[1:], base_sorted[:-1], out=newseg0[1:])
        within0 = idxn - np.maximum.accumulate(np.where(newseg0, idxn, 0))
    counts_base = np.bincount(base_sorted, minlength=M).astype(np.int64)
    ar = np.arange(n, dtype=np.int32)
    # Running per-cell offsets; +smax slack lets each unpruned corner update
    # by one shifted slice-add of counts_base instead of a fresh bincount.
    cum = np.zeros(M + smax + 1, np.int64)
    pos = 0
    for k in range(2**d):
        Lk = int(cnt_k[k])
        if Lk == 0:
            continue
        ck = int(consts[k])
        sl = slice(pos, pos + Lk)
        pos += Lk
        if Lk == n:
            np.add(base_sorted, np.int32(ck), out=flat_u[sl])
            w_u[sl] = w_pts_sorted[k]
            src_u[sl] = ar
            rank_u[sl] = cum[flat_u[sl]] + within0
            cum[ck : ck + M] += counts_base
        else:
            nzk = nz[k]
            f = base_sorted[nzk] + np.int32(ck)
            flat_u[sl] = f
            w_u[sl] = w_pts_sorted[k][nzk]
            src_u[sl] = ar[nzk]
            il = np.arange(Lk, dtype=np.int64)
            ns = np.empty(Lk, bool)
            ns[0] = True
            np.not_equal(f[1:], f[:-1], out=ns[1:])
            within = il - np.maximum.accumulate(np.where(ns, il, 0))
            rank_u[sl] = cum[f] + within
            cum[:M] += np.bincount(f, minlength=M)
    counts = cum[:M].copy()
    hist = np.bincount(rank_u) if L else np.zeros(1, np.int64)
    tail = L - np.cumsum(hist)
    return CornerStream(
        base=base, consts=consts, perm=perm, inv_perm=inv_perm, base_sorted=base_sorted,
        w_pts_sorted=w_pts_sorted, flat_u=flat_u, w_u=w_u, src_u=src_u, rank_u=rank_u,
        counts=counts, tail=tail, shape=tuple(iw.shape),
    )


class InterpPlan(NamedTuple):
    """Static interpolation plan (built once on the host, held on the device).

    * The cell-sorted stream, a CSR form of ``Wᵀ``: ``src_col (L,)`` int32
      data-order point of each sorted update, ``w_sorted (L,)`` its weight,
      ``start_ptr/end_ptr (M,)`` int32 each cell's segment (empty cells have
      ``start == end``).  Kernel K4 sums each segment in stream order.
    * ``gather_flat/gather_w (2^d, n)``: the forward ``W u`` as one fused
      gather over all corners.
    * ``slot_src/slot_w (M, K)`` and the overflow stream
      ``ov_ids/ov_src/ov_w``: the ELL layout of :func:`interp_rmatvec_bm_exact`
      (K4's plain version), ``K`` chosen by the JAX package's rule.
    """

    src_col: torch.Tensor
    w_sorted: torch.Tensor
    start_ptr: torch.Tensor
    end_ptr: torch.Tensor
    gather_flat: torch.Tensor
    gather_w: torch.Tensor
    slot_src: torch.Tensor
    slot_w: torch.Tensor
    ov_ids: torch.Tensor
    ov_src: torch.Tensor
    ov_w: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def n(self) -> int:
        return int(self.gather_w.shape[1])

    @property
    def M(self) -> int:
        return math.prod(self.shape)


def build_interp_plan(
    iw: InterpWeights,
    max_slots: int = 64,
    stream: CornerStream | None = None,
    *,
    dtype=None,
    device=None,
) -> InterpPlan:
    """Host-side (NumPy) :class:`InterpPlan` of a NumPy
    :class:`InterpWeights`, moved to ``device`` in ``dtype`` (default: the
    weights' dtype).  Pass ``stream`` to share the model's
    :class:`CornerStream`.  ``max_slots`` caps the ELL width ``K``, which
    grows while the overflow stream exceeds ``M/22`` entries (the JAX
    package's rule)."""
    st = stream if stream is not None else build_corner_stream(iw)
    M = math.prod(st.shape)
    L = int(st.flat_u.shape[0])
    # Cell-major sorted stream by counting sort: position = cell_start + rank.
    cell_bounds = np.zeros(M + 1, np.int64)
    np.cumsum(st.counts, out=cell_bounds[1:])
    pos = cell_bounds[st.flat_u] + st.rank_u
    src_data = st.perm[st.src_u].astype(np.int64)  # data-order point ids
    src = np.empty(L, np.int64)
    src[pos] = src_data
    w_sorted = np.empty(L, st.w_u.dtype)
    w_sorted[pos] = st.w_u

    max_rank = len(st.tail)
    K = 1
    while K < min(max_rank, max_slots) and int(st.tail[K - 1]) > M // 22:
        K += 1
    in_slot = st.rank_u < K
    slot_src = np.zeros((M, K), dtype=np.int64)
    slot_w = np.zeros((M, K), dtype=st.w_u.dtype)
    slot_src[st.flat_u[in_slot], st.rank_u[in_slot]] = src_data[in_slot]
    slot_w[st.flat_u[in_slot], st.rank_u[in_slot]] = st.w_u[in_slot]
    ov = ~in_slot
    gather_flat = st.base[None, :].astype(np.int64) + st.consts[:, None]
    gather_w = st.w_pts_sorted[:, st.inv_perm]

    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, st.w_u.dtype)).dtype

    def idx32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    def idx64(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64), device=device)

    def val(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    return InterpPlan(
        src_col=idx32(src), w_sorted=val(w_sorted),
        start_ptr=idx32(cell_bounds[:M]), end_ptr=idx32(cell_bounds[1:]),
        gather_flat=idx64(gather_flat), gather_w=val(gather_w),
        slot_src=idx64(slot_src), slot_w=val(slot_w),
        ov_ids=idx64(st.flat_u[ov]), ov_src=idx64(src_data[ov]), ov_w=val(st.w_u[ov]),
        shape=tuple(st.shape),
    )


def interp_rmatvec_bm_fast(plan: InterpPlan, u_bm: torch.Tensor) -> torch.Tensor:
    """Batch-major ``Wᵀ @ u`` by one running sum over the sorted stream and
    two pointer gathers (running-sum rounding, ~5e-5 relative in float32;
    refined-CG inner loops only)."""
    B = u_bm.shape[0]
    vals = plan.w_sorted[None, :] * u_bm[:, plan.src_col.long()]
    cs0 = torch.cat([torch.zeros((B, 1), dtype=u_bm.dtype, device=u_bm.device), torch.cumsum(vals, dim=1)], dim=1)
    return cs0[:, plan.end_ptr.long()] - cs0[:, plan.start_ptr.long()]


def interp_rmatvec_bm_exact(plan: InterpPlan, u_bm: torch.Tensor) -> torch.Tensor:
    """Exact batch-major ``Wᵀ @ u``: ``(B, n) → (B, M)`` via the ELL slots
    and an indexed add of the overflow stream — short per-cell sums, the plain
    version of kernel K4."""
    out = torch.sum(plan.slot_w[None, :, :] * u_bm[:, plan.slot_src], dim=-1)
    if int(plan.ov_ids.shape[0]) > 0:
        out.index_add_(1, plan.ov_ids, plan.ov_w[None, :] * u_bm[:, plan.ov_src])
    return out


def interp_matvec_bm_fast(plan: InterpPlan, v_grid_bm: torch.Tensor) -> torch.Tensor:
    """Batch-major ``W @ v`` via one fused gather over all ``2^d`` corners:
    ``(B, M) → (B, n)``.  Autograd's rule for the gather scatters with
    atomic adds on the card; differentiate through
    :func:`gp_grief_tpu_torch.ops.cuda.interp.interp_w`, whose backward is
    ``Wᵀ`` (K4)."""
    g = v_grid_bm[:, plan.gather_flat]  # (B, 2^d, n)
    return torch.sum(plan.gather_w[None, :, :] * g, dim=1)


def interp_expand(iw: InterpWeights) -> torch.Tensor:
    """Densify ``W`` to ``(n, M)`` — test oracle only."""
    M = math.prod(iw.shape)
    eye = torch.eye(M, dtype=iw.w[0].dtype, device=iw.w[0].device)
    return interp_matvec(iw, eye)
