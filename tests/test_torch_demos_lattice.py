"""The port's ``demo_ski_1m`` against the JAX package's script on the CPU.

``run(device="cpu")`` at ``chip_smoke.DEMO_CPU_ARGS``'s size (n = 10,000 on
an 8⁴ lattice, 3 steps, 64 test points), float64, against
``tools/demos_reference_jax.py`` at ``chip_smoke.DEMO_RTOL``: the demo
trains on bf16 solves (``train_mixed16``), which the two packages round
apart, so its limits are about three times the gaps measured here (stated
there).  Also the record, the script tie-check at the script's float32, the
labels of ``main``, ``main`` without a card, and the script's own assertion.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_demos as td  # noqa: E402

torch.set_num_threads(1)

NAME = "demo_ski_1m"


def test_demo_matches_jax():
    got = td.port_values(NAME)
    td.assert_matches(NAME, got, td.jax_values(NAME))
    assert got["launches"] == {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}
    # The script's assertion, and the surrogate falling over the steps.
    assert got["rmse"] < 0.05 and got["var_min"] >= 0 and got["var_max"] > 0 and got["mean_finite"]
    assert got["losses"][-1] < got["losses"][0]


def test_jax_demos_record_is_the_tool():
    td.assert_record(NAME, td.jax_values(NAME))


def test_tool_is_the_script():
    out = td.jax_stdout(NAME)
    assert td.ref.masked(out) == td.ref.masked("\n".join(td.ref.lines_ski_1m(td.jax_values(NAME, dtype="float32"))))


def test_main_prints_the_script_labels(monkeypatch, capsys):
    argv = ["--device", "cpu", "--n", "10000", "--ms", "8", "--steps", "3", "--n-test", "64"]
    td.assert_main(NAME, monkeypatch, capsys, td.port_values(NAME), argv, td.jax_stdout(NAME),
                   n=10000, ms=8, steps=3, n_test=64, device="cpu", verbose=True)


def test_main_needs_a_card():
    td.assert_main_needs_a_card(NAME)
