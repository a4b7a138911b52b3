"""Run a function on ``world_size`` ranks of one host, each in a process of
its own, and collect what each returns.

The sharded models run one process per rank.  On a node a user starts them
with ``torchrun`` (see :func:`~gp_grief_tpu_torch.parallel.mesh.init_distributed`);
:func:`spawn` is the in-program form, for tests, for the dry run and for
driving several ranks from one script: ``torch.multiprocessing`` with the
``spawn`` start method, a file store under a fresh temporary directory, and
a time limit on both the process group (a collective that never completes
raises) and the join (a rank that never returns fails the launch instead of
hanging it).  The function and its arguments must pickle; the children import
the function's module, and nothing else of the caller.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gp_grief_tpu_torch.parallel.mesh import default_backend

__all__ = ["Launch", "spawn"]


def _entry(rank: int, fn, world_size: int, backend: str, device: str, tmp: str, timeout: float, args) -> None:
    # Ranks of one host bind to the loopback interface unless told otherwise.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout))
    try:
        try:
            out = ("ok", fn(*args))
        except Exception as e:  # reported to the parent with its traceback
            out = ("error", f"rank {rank}: {type(e).__name__}: {e}\n{traceback.format_exc()}")
        path = os.path.join(tmp, f"result_{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)  # whole, before the parent can read it
    finally:
        dist.destroy_process_group()


class Launch:
    """A running :func:`spawn`; :meth:`join` waits for it."""

    def __init__(self, ctx, tmp: str, world_size: int, deadline: float):
        self._ctx, self._tmp, self._world, self._deadline = ctx, tmp, world_size, deadline

    def join(self) -> List[Any]:
        """Wait for every rank; return their results in rank order.  Raises
        ``RuntimeError`` with the failing ranks' tracebacks as soon as one
        rank has raised (the others killed: they may be waiting for it in a
        collective), and ``TimeoutError`` (the ranks killed) past the time
        limit."""
        try:
            while not self._ctx.join(timeout=max(0.1, min(1.0, self._deadline - time.monotonic()))):
                failed = self._errors()
                if failed or time.monotonic() > self._deadline:
                    self._kill()
                    if failed:
                        raise RuntimeError("spawn: " + "\n".join(failed))
                    raise TimeoutError(f"spawn: {self._world} ranks did not finish within the time limit")
            failed = self._errors() + [f"rank {r} exited without a result" for r in range(self._world)
                                       if not os.path.exists(self._path(r))]
            if failed:
                raise RuntimeError("spawn: " + "\n".join(failed))
            return [self._load(r)[1] for r in range(self._world)]
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)

    def _path(self, rank: int) -> str:
        return os.path.join(self._tmp, f"result_{rank}.pkl")

    def _load(self, rank: int):
        with open(self._path(rank), "rb") as f:
            return pickle.load(f)

    def _errors(self) -> List[str]:
        return [v for r in range(self._world) if os.path.exists(self._path(r))
                for status, v in [self._load(r)] if status != "ok"]

    def _kill(self) -> None:
        for p in self._ctx.processes:
            if p.is_alive():
                p.kill()
        for p in self._ctx.processes:
            p.join(5)


def spawn(
    fn: Callable,
    world_size: int,
    *,
    args: Sequence = (),
    backend: Optional[str] = None,
    device: str = "cuda",
    timeout: float = 300.0,
    join: bool = True,
):
    """Run ``fn(*args)`` on ranks ``0..world_size-1``, each a process with the
    default process group started.  ``device="cuda"`` (the default) puts rank
    ``r`` on card ``r mod cards``, so several ranks may share one card;
    ``device="cpu"`` is the only way onto the CPU.  ``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU.

    ``timeout`` (seconds) bounds each collective and the whole launch.  With
    ``join`` (default) returns the ranks' results in rank order, else a
    :class:`Launch` to join later (the caller may work meanwhile)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"spawn: device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: ranks run on the card by default; pass device='cpu' to run on the CPU")
    backend = backend or default_backend(device)
    tmp = tempfile.mkdtemp(prefix="gp_grief_spawn_")
    deadline = time.monotonic() + float(timeout)
    ctx = mp.start_processes(_entry, args=(fn, int(world_size), backend, device, tmp, float(timeout), tuple(args)),
                             nprocs=int(world_size), join=False, start_method="spawn")
    launch = Launch(ctx, tmp, int(world_size), deadline)
    return launch.join() if join else launch
