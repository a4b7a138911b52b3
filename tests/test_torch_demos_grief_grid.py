"""The port's demos against the JAX package's scripts, float64 on the CPU:
``demo_1d_regression``, ``demo_grief_highdim`` and ``demo_kron_grid``.

For each demo: the port's ``run(device="cpu")`` at
``chip_smoke.DEMO_CPU_ARGS``'s sizes against ``tools/demos_reference_jax.py``
on the same data, at ``chip_smoke.DEMO_RTOL`` (stated and measured there:
float64 Adam and closed-form values 1e-9; demo_1d_regression's L-BFGS at its
converged NLMLs only; demo_kron_grid's trained values where Adam follows
rounding); ``chip_smoke.JAX_DEMOS`` against the live tool at 1e-12; the
tool against the script's own printed lines; the port's ``main`` printing
the script's labels; and ``main`` raising without a card.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_demos as td  # noqa: E402

torch.set_num_threads(1)

DEMOS = ["demo_1d_regression", "demo_grief_highdim", "demo_kron_grid"]
MAIN_ARGV = {
    "demo_1d_regression": (["--device", "cpu", "--n", "300"], dict(n=300, device="cpu")),
    "demo_grief_highdim": (["--device", "cpu", "--d", "8", "--n", "300", "--p", "40", "--ard-iters", "5"],
                           dict(d=8, n=300, p=40, ard_iters=5, device="cpu")),
    "demo_kron_grid": (["--device", "cpu", "--world", "2"], dict(world=2, device="cpu")),
}


@pytest.mark.parametrize("name", DEMOS)
def test_demo_matches_jax(name):
    got = td.port_values(name)
    td.assert_matches(name, got, td.jax_values(name))
    assert got["launches"] == {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}  # no kernel runs on the CPU
    assert got["wall_s"] > 0


@pytest.mark.parametrize("name", DEMOS)
def test_jax_demos_record_is_the_tool(name):
    td.assert_record(name, td.jax_values(name))


@pytest.mark.parametrize("name", DEMOS)
def test_tool_is_the_script(name):
    td.assert_tie(name, td.jax_values(name))


@pytest.mark.parametrize("name", DEMOS)
def test_main_prints_the_script_labels(name, monkeypatch, capsys):
    argv, expect = MAIN_ARGV[name]
    td.assert_main(name, monkeypatch, capsys, td.port_values(name), argv, td.jax_stdout(name), **expect)


@pytest.mark.parametrize("name", DEMOS)
def test_main_needs_a_card(name):
    td.assert_main_needs_a_card(name)


def test_grief_highdim_trains_the_relevant_dimensions():
    v = td.port_values("demo_grief_highdim")
    assert v["ll_ard"] > v["ll_init"] and v["ll_polish"] > v["ll_ard"]
    assert v["relevant"][:2] == [0, 1] and v["mean_finite"]  # the two strongest signals lead


def test_kron_grid_sections():
    """The mesh section's ranks agree with each other and with the one-device
    model; the grouped axis spans two input columns."""
    v = td.port_values("demo_kron_grid")
    assert v["mesh"] == {"data": 1, "model": 2} and len(set(v["mesh_nlml_ranks"])) == 1
    assert v["mesh_nlml"] == pytest.approx(v["nlml"], rel=1e-9)
    assert v["grouped_dims"] == [[0], [1, 2]] and v["nlml_trained"] > v["nlml"] and v["mean_finite"]
    assert v["var_min"] >= 0 and v["grouped_var_min"] >= 0


def test_kron_grid_keeps_its_kernel_variances_equal():
    """The departure behind demo_kron_grid's trained limits: the three
    kernels' log-variances (leaves 1, 3, 5; only their sum is identified)
    get equal gradients in exact arithmetic, and Adam steps each by about
    the learning rate on the sign of a near-zero gradient.  After 60 steps
    the port's three stay within 4e-12 of each other (measured), the JAX
    package's 1.5e-3 apart."""
    got, want = td.port_values("demo_kron_grid")["params"], td.jax_values("demo_kron_grid")["params"]
    assert np.ptp([got[1], got[3], got[5]]) < 1e-9
    assert np.ptp([want[1], want[3], want[5]]) > 1e-4
