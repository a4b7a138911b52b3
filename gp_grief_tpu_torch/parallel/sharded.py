"""Data- and model-parallel GP-GRIEF pieces on ``torch.distributed``.

Counterpart of ``gp_grief_tpu.parallel.sharded``.  Every rank runs this
code as one process of an SPMD program (``shard_map``'s body, with the
collectives of ``ops.collectives``):

    rank k holds rows X_k, y_k:
        Φ_k = φ(X_k)                     (local: kernel K1 on the card)
        C   = Σ_k Φ_kᵀ Φ_k   → psum      (p×p)
        v   = Σ_k Φ_kᵀ y_k   → psum      (p,)
    every rank then computes the same O(p³) NLML and its gradient.

The basis build is replicated (O(Σ m_d³)); with a 2-D ``(data, model)``
mesh its per-dimension ``eigh`` can be split over the ``model`` axis
(:func:`stacked_eigh_sharded`).  Gradients flow through the collectives by
``ops.collectives``' convention: a replicated tensor entering a rank's
rows goes through ``replicate``, so the basis and the kernel parameters
receive the sum of the ranks' parts once.

A rank's rows are the ``k``-th of ``world`` equal blocks of the padded data
(:func:`pad_to_multiple`), ``k`` its coordinate on the data axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gp_grief_tpu_torch.kernels.grief import GriefBasis, build_basis, phi
from gp_grief_tpu_torch.models.base import BasisStats, basis_nlml
from gp_grief_tpu_torch.ops.cuda.kron import kernel_for
from gp_grief_tpu_torch.ops.kron_fast import batch_identity, kernel_route, kron_matvec_fast
from gp_grief_tpu_torch.ops.collectives import (
    all_gather,
    axis_index,
    axis_size,
    psum,
    psum_scatter,
    replicate,
)

__all__ = [
    "kron_matvec_sharded",
    "local_rows",
    "pad_to_multiple",
    "sharded_basis_stats",
    "sharded_grief_nlml",
    "stacked_eigh_sharded",
]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` with zeros along ``axis`` to a multiple; return (padded, mask).

    The mask (1 real / 0 pad) is applied as a row weight: padded rows then
    contribute nothing to ``ΦᵀΦ``/``Φᵀy``/``yᵀy``.
    """
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    pad_n = target - n
    mask = np.ones((target,), dtype=x.dtype)
    if pad_n:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad_n)
        x = np.pad(x, widths)
        mask[n:] = 0.0
    return x, mask


def local_rows(n_pad: int, mesh, axis_name: str = "data") -> slice:
    """This rank's block of ``n_pad`` rows sharded over ``axis_name``."""
    k, w = axis_index(mesh, axis_name), axis_size(mesh, axis_name)
    if n_pad % w:
        raise ValueError(f"{n_pad} rows do not split over {w} ranks; pad them (pad_to_multiple)")
    n_loc = n_pad // w
    return slice(k * n_loc, (k + 1) * n_loc)


class _ReplicatedKernel:
    """A kernel module called with its parameters replaced by their
    ``replicate``-d views (``torch.func.functional_call``), so the rows'
    gradients reach the parameters summed over the ranks."""

    def __init__(self, module, params):
        self._module, self._params = module, params

    def __call__(self, *args):
        return torch.func.functional_call(self._module, self._params, args)


def _replicated_inputs(basis: GriefBasis, kernels, d: int, group):
    """The basis and the kernels, every float tensor through one
    ``replicate``."""
    kerns = list(kernels) if isinstance(kernels, (list, tuple, torch.nn.ModuleList)) else [kernels] * d
    unique = list({id(k): k for k in kerns}.values())
    named = [(i, n, p) for i, k in enumerate(unique) for n, p in k.named_parameters()]
    basis_ts = [*basis.Qs, *basis.lams, basis.log_lam]
    rep = replicate(basis_ts + [p for _, _, p in named], group)
    rb = GriefBasis(Qs=tuple(rep[:d]), lams=tuple(rep[d : 2 * d]), log_lam=rep[2 * d], idx=basis.idx)
    params = [{} for _ in unique]
    for (i, n, _), t in zip(named, rep[2 * d + 1 :]):
        params[i][n] = t
    by_id = {id(k): _ReplicatedKernel(k, params[i]) for i, k in enumerate(unique)}
    return rb, [by_id[id(k)] for k in kerns]


def local_basis_stats(basis: GriefBasis, kernels, xg, x: torch.Tensor, y: torch.Tensor, row_mask: torch.Tensor,
                      group, *, n: int, dims=None, chunk: int = 131072) -> BasisStats:
    """:class:`BasisStats` of this rank's rows ``(x, y)`` (``row_mask`` their
    weight, 0 on pad rows), summed over ``group`` by one ``psum``.

    ``Φ`` is assembled ``chunk`` rows at a time (kernel K1 on the card), so
    a rank never holds more than one ``chunk × p`` block of it; under
    autograd each chunk is checkpointed (its ``Φ`` rebuilt in the backward)
    for the same bound."""
    rb, rk = _replicated_inputs(basis, kernels, len(xg), group)

    def part(xk, yk, mk):
        Phik = phi(rb, rk, xg, xk, dims=dims) * mk[:, None]
        yk = yk * mk
        return Phik.T @ Phik, Phik.T @ yk, torch.dot(yk, yk)

    grad = torch.is_grad_enabled()
    C = v = yy = 0.0
    for s in range(0, x.shape[0], chunk):
        args = (x[s : s + chunk], y[s : s + chunk], row_mask[s : s + chunk])
        c, vk, yk2 = checkpoint(part, *args, use_reentrant=False) if grad else part(*args)
        C, v, yy = C + c, v + vk, yy + yk2
    C, v, yy = psum((C, v, yy), group)
    return BasisStats(C=C, v=v, yy=yy, n=int(n))


def _as_tensor(a, like: torch.Tensor) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype=like.dtype, device=like.device)
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def sharded_basis_stats(
    basis: GriefBasis,
    kernels,
    xg,
    x,
    y,
    row_mask,
    mesh,
    *,
    axis_name: str = "data",
    n_real: Optional[int] = None,
    dims=None,
    chunk: int = 131072,
) -> BasisStats:
    """``BasisStats`` with rows of ``(x, y)`` sharded over ``axis_name``.

    ``x``, ``y``, ``row_mask``: the padded data (:func:`pad_to_multiple`), the
    same on every rank; each rank takes its block (:func:`local_rows`) to its
    basis' device.  ``dims`` groups input columns into grid dimensions, as in
    ``phi``.  See :func:`local_basis_stats`."""
    ref = basis.log_lam
    n_pad = int(x.shape[0])
    rows = local_rows(n_pad, mesh, axis_name)
    xl, yl, ml = (_as_tensor(a, ref)[rows] for a in (x, y, row_mask))
    n = int(n_real if n_real is not None else n_pad)
    return local_basis_stats(basis, kernels, xg, xl, yl, ml, mesh.get_group(axis_name), n=n, dims=dims, chunk=chunk)


def sharded_grief_nlml(
    params,
    xg,
    x,
    y,
    row_mask,
    mesh,
    *,
    n_eigs: int,
    dim_noise_var: float = 1e-12,
    axis_name: str = "data",
    n_real: Optional[int] = None,
    dims=None,
) -> torch.Tensor:
    """Full data-parallel NLML: replicated basis build + sharded reductions.

    ``params``: ``{"kernels": [...], "log_w": (p,), "log_noise": ()}``, the
    same on every rank; differentiable end to end, through the basis build
    too (``opt_kernel_params`` semantics)."""
    basis = build_basis(params["kernels"], xg, n_eigs, dim_noise_var=dim_noise_var)
    stats = sharded_basis_stats(basis, params["kernels"], xg, x, y, row_mask, mesh,
                                axis_name=axis_name, n_real=n_real, dims=dims)
    return basis_nlml(stats, params["log_w"], params["log_noise"])


def _local_route(factors, block, B: int, precision, v: torch.Tensor):
    """The kernel (``"slab"`` / ``"fused"``) a rank's trailing product runs
    on: its ``block`` ``(I_{m₁/k} ⊗ rest)``, the rank's leading rows a
    ``batch_identity``, wherever the whole product would take a kernel (so
    that sharding keeps the single card's route) and the Hopper plan takes
    the block.  None: the chain."""
    if not v.is_cuda or kernel_route(factors, B, precision, vector_dtype=v.dtype) == "chain":
        return None
    try:
        return kernel_route(block, B, precision, vector_dtype=v.dtype, impl=kernel_for(block, B))
    except ValueError:
        return None


def kron_matvec_sharded(factors, v: torch.Tensor, mesh, *, axis_name: str = "model",
                        precision="highest") -> torch.Tensor:
    """Model-parallel ``(⊗_d K_d) @ v`` with the lattice's leading axis
    sharded over ``axis_name``.

    ``v``: this rank's block of lattice rows, ``(M/k,)`` or ``(M/k, B)`` with
    ``k`` the axis size (rank ``j`` holds leading indices
    ``a₁ ∈ [j·m₁/k, (j+1)·m₁/k)``); returns its block of the product.  The
    trailing factors act within the block (``kron_matvec_fast``, so kernels
    K2/K3 on the card wherever the whole product would take one), the
    leading factor's column slice ``K₁[:, block]`` is one ``torch.matmul``,
    and one ``reduce_scatter`` returns each rank its output rows.  ``m₁``
    (and the leading output size) must divide by ``k``.  Gradients reach the
    factors (replicated) and ``v``."""
    group = mesh.get_group(axis_name)
    km, j = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    B = int(v2.shape[1])
    m1, m1o = int(factors[0].shape[1]), int(factors[0].shape[0])
    if m1 % km or m1o % km:
        raise ValueError(f"leading factor size {m1}->{m1o} must divide mesh axis {km}")
    m1_loc = m1 // km
    R = int(v2.shape[0]) // m1_loc
    factors = replicate(tuple(K.contiguous() for K in factors), group)
    K1, rest = factors[0], tuple(factors[1:])
    x3 = v2.reshape(m1_loc, R, B)
    block = (batch_identity(m1_loc, dtype=K1.dtype, device=K1.device), *rest) if rest else None
    route = _local_route(factors, block, B, precision, v2) if rest else None
    if route:
        # The kernel on the block, the rank's leading rows the plan's lead.
        yk = kron_matvec_fast(block, v2.reshape(m1_loc * R, B), precision=precision, impl=route)
        Ro = int(yk.shape[0]) // m1_loc
        yk = yk.reshape(m1_loc, Ro, B)
    elif rest:
        xrows = x3.permute(1, 2, 0).reshape(R, B * m1_loc)
        yrows = kron_matvec_fast(rest, xrows.contiguous(), precision=precision)
        Ro = int(yrows.shape[0])
        yk = yrows.reshape(Ro, B, m1_loc).permute(2, 0, 1)
    else:
        yk, Ro = x3, R
    K1_cols = K1[:, j * m1_loc : (j + 1) * m1_loc]
    partial = (K1_cols @ yk.reshape(m1_loc, Ro * B)).reshape(m1o, Ro, B)
    out = psum_scatter(partial, group).reshape(-1, B)
    return out[:, 0] if squeeze else out


def stacked_eigh_sharded(Ks: torch.Tensor, mesh, axis_name: str = "model"):
    """Batched symmetric ``eigh`` of stacked equal-size factors ``(d, m, m)``
    split over the mesh axis ``axis_name``: rank ``j`` decomposes its block
    of the factors (the stack padded with identities to a multiple of the
    axis size) and one ``all_gather`` returns every rank all of them.
    Returns ``(Qs (d, m, m), lams (d, m))``, the same on every rank;
    differentiable (the gradient reaches every factor once)."""
    group = mesh.get_group(axis_name)
    km, j = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    d, m = int(Ks.shape[0]), int(Ks.shape[1])
    b = -(-d // km)
    if b * km != d:
        eye = torch.eye(m, dtype=Ks.dtype, device=Ks.device).expand(b * km - d, m, m)
        Ks = torch.cat([Ks, eye], dim=0)
    mine = replicate(Ks, group)[j * b : (j + 1) * b]
    lams, Qs = torch.linalg.eigh(mine)
    both = all_gather(torch.cat([Qs, lams[:, None, :]], dim=1), group)[:d]
    return both[:, :m, :], both[:, m, :]
