"""uci2m_grief.nlml end to end on the CPU at a small size: the iterative
NLML sweep agrees with the plain reference, a traced run reports the cell's
per-layer metrics (and leaves the span readers' out where the program keeps
no spans),
and half the probes or an altered NLML turn ``correct`` false."""

import math

from gp_grief_tpu_torch.utils import profiling
from gpbench import faults, run
from gpbench.tests.conftest import bench, load

B = bench()
CELL = "uci2m_grief.nlml"
# The metrics that read the program's spans and counters; besides them the
# cell lists cg_iters.nlml (the model's own count) and idle_share.nlml (the
# device trace: nothing to read on the CPU).
METRICS = {"grief_prep_share.nlml", "grief_applies.nlml", "host_reads.nlml"}
LISTED = METRICS | {"cg_iters.nlml", "idle_share.nlml"}
# The CPU's float32 program against the float64 reference at this size.
CPU_LIMIT = {"nlml": 1e-4}


def _tiny():
    cfg = load("configs", "uci2m_grief")
    cfg.update(n=3000, d=6, n_eigs=40, grid={"points": 6, "low": -1.1, "high": 1.1})
    cfg["model"]["precond_rank"] = 20
    return cfg, load("traffic", "grief_nlml_sweep")


def _run(trace_on=False, fault=None):
    cfg, traffic = _tiny()
    with faults.planted(fault):
        return run.execute(CELL, B, cfg, traffic, CPU_LIMIT, seed=2**31 + 4242, seconds=0.5, trace_on=trace_on,
                           device="cpu")


def test_the_cell_is_in_the_benchmark():
    entry = next(w for w in B["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 1 and load("limits", CELL).keys() == {"nlml"}
    assert CELL in next(m for m in B["end_to_end"] if m["name"] == "nlml_ms")["workloads"]
    assert {m["name"] for m in B["per_layer"] if CELL in m.get("workloads", [])} == LISTED


def test_sound_run():
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2, out["checks"]
    assert set(out["metrics"]) == {"nlml_ms", "setup_s"}


def test_traced_run_reports_its_metrics():
    profiling.reset()
    out = _run(trace_on=True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == METRICS | {"cg_iters.nlml"}
    assert 0.0 < got["grief_prep_share.nlml"] < 100.0
    assert got["grief_applies.nlml"] >= 2 * 48 and math.isfinite(got["grief_applies.nlml"])
    assert got["cg_iters.nlml"] >= 48 and got["host_reads.nlml"] >= 2


def test_a_program_without_spans_leaves_them_out(monkeypatch):
    monkeypatch.delattr(profiling, "snapshot")
    out = _run(trace_on=True)
    assert out["correct"] and not (set(out["metrics"]) & METRICS), out


def test_half_probes_fails():
    assert _run(fault="half_probes")["correct"] is False


def test_an_altered_nlml_fails(monkeypatch):
    """An NLML off by a thousandth of itself (``faults.altered_answer``
    plants its fault on the SKI model only)."""
    from gp_grief_tpu_torch.models.gp_grief import GPGriefModel

    nlml = GPGriefModel.log_likelihood_iterative_segmented

    def altered(self, *a, **kw):
        ll = nlml(self, *a, **kw)
        return ll - 1e-3 * abs(ll)

    monkeypatch.setattr(GPGriefModel, "log_likelihood_iterative_segmented", altered)
    out = _run()
    assert out["correct"] is False and out["checks"]["nlml"]["value"] > 0.5e-3, out["checks"]

