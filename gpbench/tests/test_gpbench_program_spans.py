"""The readers of the program's own spans and counters (``gpbench/spans.py``):
a traced run of each cell on the CPU reports each of them that the cell
lists, as a finite number; an untraced run reports none; and a program
without them leaves them out rather than failing."""

import math

import pytest

from gp_grief_tpu_torch.utils import profiling
from gpbench import run
from gpbench.metrics import host_reads, kron_host_us, prep_share, solver_iters
from gpbench.tests.conftest import bench, tiny_cell

B = bench()
CELLS = [w["name"] for w in B["workloads"]]
READERS = {"host_reads": host_reads, "solver_iters": solver_iters, "kron_host_us": kron_host_us,
           "prep_share": prep_share}
PROGRAM = {m["name"] for m in B["per_layer"] if m["name"].split(".")[0] in READERS}


@pytest.mark.parametrize("traced", [True, False], ids=["traced", "untraced"])
@pytest.mark.parametrize("workload", CELLS)
def test_program_metrics(workload, traced):
    profiling.reset()
    cfg, traffic, limits = tiny_cell(workload)
    out = run.execute(workload, B, cfg, traffic, limits, seed=2**31 + 777, seconds=0.0, trace_on=traced,
                      device="cpu")
    got = {k: v["value"] for k, v in out["metrics"].items() if k in PROGRAM}
    if not traced:
        assert got == {}
        return
    listed = {m["name"] for m in B["per_layer"] if m["name"] in PROGRAM and workload in m["workloads"]}
    assert listed and set(got) == listed
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    if "prep_share.predict" in got:
        assert got["prep_share.predict"] < 100.0


def test_a_program_without_them_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    ctx = {"units": [{"steps": 1}]}
    assert all(r.read(ctx) is None for r in READERS.values())
