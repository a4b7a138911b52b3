"""Device meshes and process-group start-up on ``torch.distributed``.

Counterpart of ``gp_grief_tpu.parallel.mesh``.  JAX sees every device from
one process and names mesh axes over them; here each rank is one process on
one device, and a mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh`
over the ranks of the default process group, its named axes carrying one
process group each (``mesh.get_group("data")``).  The JAX module's ``P`` and
``NamedSharding`` have no torch meaning and are not ported: a sharded model
holds its own rows, and a replicated tensor is the same on every rank.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["data_mesh", "default_backend", "init_distributed", "make_mesh"]


def default_backend(device_type: str) -> str:
    """``nccl`` for CUDA ranks, ``gloo`` for CPU ranks."""
    return "nccl" if device_type == "cuda" else "gloo"


def _default_device_type() -> str:
    """The card; with no CUDA device this raises rather than running quietly
    on the CPU (``models.base.resolve_device``'s rule)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: meshes run on the card by default; pass device_type='cpu' (or backend='gloo') "
            "to run on the CPU"
        )
    return "cuda"


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> int:
    """Start the default process group, and return its world size.

    From the arguments (``init_method`` defaults to ``env://``), or with no
    arguments in an environment that announces one (``torchrun``'s ``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR``).  Otherwise, in a bare single
    process, it touches nothing and returns 1; a process group already
    running is left as it is and its size returned.  ``backend`` defaults to
    ``nccl`` (a CPU group needs ``backend="gloo"``; with no CUDA device and no
    ``backend`` this raises); with ``nccl`` the rank takes the card
    ``LOCAL_RANK`` (else its rank) modulo the cards visible.  ``timeout``
    (seconds) bounds every collective of the group."""
    if dist.is_initialized():
        return dist.get_world_size()
    explicit = any(a is not None for a in (init_method, world_size, rank))
    announced = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if not explicit and not announced:
        return 1
    backend = backend or default_backend(_default_device_type())
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank, **kw)
    return dist.get_world_size()


def _ensure_group(device_type: str) -> None:
    """A process with no process group gets a world-1 group of its own (an
    in-memory store), the torch form of JAX's one-device host."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group(default_backend(device_type), store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str],
    *,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A mesh of the given logical shape over the first ``prod(shape)`` ranks
    of the default process group (rank-major, as the JAX package lays its
    devices out).  ``device_type`` defaults to ``"cuda"``; ``"cpu"`` is the
    only way onto the CPU, and with no CUDA device and no ``device_type``
    this raises.  In a process with no process group this starts a
    world-1 one (so a one-rank mesh always works)."""
    device_type = device_type or _default_device_type()
    _ensure_group(device_type)
    n = math.prod(int(s) for s in shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} ranks, have {world}")
    ranks = torch.arange(n).reshape(tuple(int(s) for s in shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def data_mesh(n_devices: Optional[int] = None, axis_name: str = "data", *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """1-D data-parallel mesh over all (or the first ``n_devices``) ranks;
    ``device_type`` as in :func:`make_mesh`."""
    device_type = device_type or _default_device_type()
    _ensure_group(device_type)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return make_mesh((n,), (axis_name,), device_type=device_type)
