"""Shared helpers of the benchmark's tests: tiny CPU versions of each cell.

Tests that need the card take the ``cuda`` marker and decide inside the
test whether there is one."""

import json
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def load(kind: str, name: str) -> dict:
    return json.loads((PKG / kind / f"{name}.json").read_text())


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cfg(name: str) -> dict:
    """The configuration at a size the CPU runs in seconds: the same
    family, data, kernel and solver settings, fewer points."""
    cfg = load("configs", name)
    if cfg["family"] == "ski":
        cfg["n"] = 5000
        cfg["grid"]["points"] = 8
    else:
        cfg["n"] = 600
        cfg["model"]["matvec_chunk"] = 256
        cfg["model"]["precond_rank"] = 32
    return cfg


def tiny_cell(workload: str):
    """``(cfg, traffic, limits)`` of ``workload`` at the tiny size, with
    fits of three steps."""
    entry = next(w for w in bench()["workloads"] if w["name"] == workload)
    traffic = load("traffic", entry["traffic"])
    if "steps" in traffic:
        traffic["steps"] = 3
    return tiny_cfg(entry["config"]), traffic, load("limits", workload)


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
