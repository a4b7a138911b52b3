"""Differentiable collectives on ``torch.distributed`` process groups.

The JAX package runs its sharded bodies under ``shard_map`` and reduces with
``lax.psum`` / ``lax.psum_scatter``; here every rank is its own process and
the same reductions are calls on a process group (one axis of a
:class:`~torch.distributed.device_mesh.DeviceMesh`, ``mesh.get_group(axis)``).
The JAX package needs nothing like this module: ``jax.grad`` transposes its
collectives itself.

Gradients follow one convention.  Every rank evaluates the same replicated
objective and calls ``backward()`` on it, so a cotangent that arrives at a
replicated tensor is already the whole gradient, and one that arrives at a
rank's local shard is that shard's part.  Hence the pair:

* :func:`psum` sums shards into a replicated value; its backward is the
  identity (each shard receives the replicated cotangent once).
* :func:`replicate` marks a replicated tensor entering a rank's local work;
  its backward sums the ranks' partial cotangents (``all_reduce``).

``torch.distributed.nn.functional.all_reduce`` all-reduces in its backward
too, which hands every shard ``world_size`` times its gradient when the
consumer is replicated; this module never does that.

Each call is counted in :data:`STATS` (calls, bytes sent into the collective
by this rank, and the host seconds spent in the call: the whole collective on
gloo, the enqueue only on NCCL), for the measurement of the sharded paths.
A collective the backend cannot run raises; nothing is copied through the
host here.
"""

from __future__ import annotations

import time
from typing import Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["STATS", "all_gather", "axis_index", "axis_size", "psum", "psum_scatter", "replicate", "reset_stats"]

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]

STATS = {"calls": {}, "bytes": {}, "seconds": {}}

# Newer torch renames the tensor forms of the two collectives.
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def reset_stats() -> None:
    """Zero :data:`STATS`."""
    for v in STATS.values():
        v.clear()


def _count(name: str, t: torch.Tensor, t0: float) -> None:
    STATS["calls"][name] = STATS["calls"].get(name, 0) + 1
    STATS["bytes"][name] = STATS["bytes"].get(name, 0) + t.numel() * t.element_size()
    STATS["seconds"][name] = STATS["seconds"].get(name, 0.0) + time.perf_counter() - t0


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    t0 = time.perf_counter()
    dist.all_reduce(out, group=group)
    _count("all_reduce", out, t0)
    return out


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts]) if len(ts) > 1 else ts[0].reshape(-1)


def _split(flat: torch.Tensor, like) -> tuple:
    if len(like) == 1:
        return (flat.view(like[0].shape),)
    out, off = [], 0
    for t in like:
        # Separate tensors, not views of one buffer: a caller may write one.
        out.append(flat[off : off + t.numel()].reshape(t.shape).clone())
        off += t.numel()
    return tuple(out)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        return _split(_all_reduce(_flat(xs), group), xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=dt, device=dv) if g is None else g for g, (s, dt, dv) in zip(gs, ctx.like)]
        return (None, *_split(_all_reduce(_flat(gs), ctx.group), gs))


def _many(fn, xs: Tensors, group):
    if isinstance(xs, torch.Tensor):
        return fn.apply(group, xs)[0]
    xs = tuple(xs)
    if len({(x.dtype, x.device) for x in xs}) > 1:
        raise TypeError(f"{fn.__name__}: the tensors of one call must share a dtype and device")
    return fn.apply(group, *xs)


def psum(x: Tensors, group) -> Tensors:
    """Sum ``x`` over the ranks of ``group`` (``lax.psum``): every rank gets
    the total.  A sequence of tensors (one dtype and device) goes through one
    ``all_reduce``.

    Backward: the identity.  The result is consumed replicated (every rank
    runs the same objective on it), so each rank's shard receives the
    cotangent once."""
    return _many(_Psum, x, group)


def replicate(x: Tensors, group) -> Tensors:
    """Mark a replicated ``x`` (the same on every rank of ``group``) entering
    rank-local work: the value unchanged (a view).  A sequence of tensors
    shares one collective in the backward.

    Backward: ``all_reduce`` of the cotangent, so the ranks' partial
    gradients through their local shards add up to the whole, once.  This is
    ``psum``'s transpose, the step ``jax.grad`` takes for a replicated input
    of ``shard_map``."""
    return _many(_Replicate, x, group)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        world = dist.get_world_size(group)
        if x.shape[0] % world:
            raise ValueError(f"psum_scatter: leading size {x.shape[0]} does not divide {world} ranks")
        x = x.contiguous()
        out = torch.empty((x.shape[0] // world, *x.shape[1:]), dtype=x.dtype, device=x.device)
        t0 = time.perf_counter()
        _REDUCE_SCATTER(out, x, group=group)
        _count("reduce_scatter", x, t0)
        return out

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``: sum
    ``x`` over the ranks, and return this rank's block of leading rows
    (``reduce_scatter_tensor``).  ``x.shape[0]`` must divide by the group's
    size.

    Backward: ``all_gather`` of the cotangent blocks (every rank's ``x``
    reached every output block)."""
    return _PsumScatter.apply(x, group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((world * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    t0 = time.perf_counter()
    _ALL_GATHER(out, x, group=group)
    _count("all_gather", x, t0)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n : (ctx.rank + 1) * ctx.n], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along the leading dimension, in rank
    order (``all_gather_into_tensor``; ``lax.all_gather(tiled=True)``).

    Backward: this rank's block of the cotangent.  The result is consumed
    replicated, so each rank's cotangent is already the whole one."""
    return _AllGather.apply(x, group)


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along the mesh axis ``axis``."""
    return int(mesh.shape[list(mesh.mesh_dim_names).index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along the mesh axis ``axis``
    (``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))
