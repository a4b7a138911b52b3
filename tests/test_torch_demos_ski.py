"""The port's ``demo_ski_mixed`` and ``demo_exact_matrixfree`` against the
JAX package's scripts, float64 on the CPU.

As in ``test_torch_demos_grief.py``: ``run(device="cpu")`` at
``chip_smoke.DEMO_CPU_ARGS``'s sizes against ``tools/demos_reference_jax.py``
at ``chip_smoke.DEMO_RTOL`` (1e-9: both CGs stop at the demos' tolerances
after the same iterations, so the values differ by rounding), the record,
the script tie-check (demo_exact_matrixfree at the script's float32), the
labels of ``main`` and ``main`` without a card.  Both packages draw
``chip_smoke.demo_probe``'s probes.  In the JAX package on the CPU
``cg_precision="mixed"`` is ``"exact"``; the port's "default" grade rounds
the Kronecker operands to bf16 on the CPU too, and its refined CG still
lands within the limit of JAX's exact run.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_demos as td  # noqa: E402

torch.set_num_threads(1)

DEMOS = ["demo_ski_mixed", "demo_exact_matrixfree"]
# The script's own dtype where it fixes one (DEMO_CPU_ARGS runs float64).
SCRIPT_DTYPE = {"demo_ski_mixed": {}, "demo_exact_matrixfree": {"dtype": "float32"}}
MAIN_ARGV = {
    "demo_ski_mixed": (["--device", "cpu", "--n", "600", "--mbar", "10"], dict(n=600, mbar=10, device="cpu")),
    "demo_exact_matrixfree": (["--device", "cpu", "--n", "1000"], dict(n=1000, device="cpu")),
}


@pytest.mark.parametrize("name", DEMOS)
def test_demo_matches_jax(name):
    got = td.port_values(name)
    td.assert_matches(name, got, td.jax_values(name))
    assert got["launches"] == {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}


@pytest.mark.parametrize("name", DEMOS)
def test_jax_demos_record_is_the_tool(name):
    td.assert_record(name, td.jax_values(name))


@pytest.mark.parametrize("name", DEMOS)
def test_tool_is_the_script(name):
    out = td.jax_stdout(name)
    want = td.ref.ALL[name][1](td.jax_values(name, **SCRIPT_DTYPE[name]))
    assert td.ref.masked(out) == td.ref.masked("\n".join(want))


@pytest.mark.parametrize("name", DEMOS)
def test_main_prints_the_script_labels(name, monkeypatch, capsys):
    argv, expect = MAIN_ARGV[name]
    td.assert_main(name, monkeypatch, capsys, td.port_values(name), argv, td.jax_stdout(name), **expect)


@pytest.mark.parametrize("name", DEMOS)
def test_main_needs_a_card(name):
    td.assert_main_needs_a_card(name)


def test_ski_mixed_trains_both_precisions():
    v = td.port_values("demo_ski_mixed")
    for prec in ("exact", "mixed"):
        assert v[prec]["ll"] > v[prec]["ll_init"] and v[prec]["mean_finite"] and v[prec]["cg_iterations"] > 0
    assert v["mixed"]["ll"] == pytest.approx(v["exact"]["ll"], rel=1e-9)
