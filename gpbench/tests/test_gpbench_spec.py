"""``BENCHMARK.json`` keeps to its format: names, units, keys and
lengths, and every file and reader it names exists."""

import importlib
import re

import pytest

from gpbench.tests.conftest import PKG, ROOT, bench, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
B = bench()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16 and all(PATH.match(p) for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(B["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        cfg = load("configs", c["name"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PKG / "limits" / f"{w['name']}.json").is_file()
        importlib.import_module(f"gpbench.drivers.{load('traffic', w['traffic'])['driver']}")
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    keys = {"name", "unit", "better", "source"} | ({"bound"} if m in B["end_to_end"] else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in B["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock") and _line(m["layer"])
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        importlib.import_module(f"gpbench.metrics.{m['name'].split('.')[0]}")


def test_every_cell_reports_enough():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for w in B["workloads"]:
        e2e = [m for m in B["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and any(m["name"] == "setup_s" for m in e2e)
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in B["per_layer"])
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
