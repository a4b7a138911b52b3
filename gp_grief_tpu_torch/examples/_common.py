"""What the demos share: device and recipe, kernel launch counts, wall time."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gp_grief_tpu_torch.ops.cuda import interp_wt, kron_matvec_fused, kron_matvec_slab, phi_fused, wtw_stencil

# The wrappers that count their kernels' launches, by the ids of PERF.md §6.
COUNTERS = {"K1": phi_fused, "K2": kron_matvec_slab, "K3": kron_matvec_fused, "K4": interp_wt, "K5": wtw_stencil}


def launches() -> dict:
    """The K1-K5 wrappers' launch counts in this process."""
    return {k: int(fn.launches) for k, fn in COUNTERS.items()}


def since(before: dict) -> dict:
    """Launches of each kernel since ``before`` (a :func:`launches`)."""
    now = launches()
    return {k: now[k] - before[k] for k in COUNTERS}


def summed(counts) -> dict:
    """The launches of several processes (ranks), kernel by kernel."""
    return {k: sum(c[k] for c in counts) for k in COUNTERS}


def start(device) -> tuple:
    """``(launches(), clock(device))`` at the start of a demo; raises without
    a CUDA device unless ``device`` is the CPU (there is no fallback)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the demos run on the card; pass --device cpu (device='cpu') "
                           "to run on the CPU")
    return launches(), clock(device)


def recipe_of(device: str, recipe) -> str:
    """``"cpu"`` (the JAX script's CPU branch) or ``"card"`` (its accelerator
    branch); by default the one of ``device``."""
    recipe = recipe or ("cpu" if torch.device(device).type == "cpu" else "card")
    if recipe not in ("cpu", "card"):
        raise ValueError(f"recipe must be 'cpu' or 'card', not {recipe!r}")
    return recipe


def torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else {np.float32: torch.float32, np.float64: torch.float64}[
        np.dtype(dtype).type]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def clock(device) -> float:
    """The host clock, after the card's queue has drained."""
    sync(device)
    return time.perf_counter()


def rank_start(device: str, rank_init) -> dict:
    """A spawned rank's start: on the CPU, its share of the host's cores (the
    ranks run side by side); then ``rank_init()``.  Returns :func:`launches`."""
    if device == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // torch.distributed.get_world_size()))
    if rank_init is not None:
        rank_init()
    return launches()


def peak_gb(device: str):
    """This process's peak device memory (GB) on the card, else None."""
    return torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None


def backend_for(device: str, world: int) -> str:
    """gloo on the CPU, and where ranks must share a card (NCCL refuses two
    ranks on one card); NCCL otherwise."""
    if torch.device(device).type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    return ap


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
