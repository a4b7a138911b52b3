"""The port's ``demo_sharded`` against the JAX package's script on the CPU.

The JAX demo spans every device of this process (conftest's 8 virtual CPU
devices); the port runs at world 2 (gloo ranks).  The sums over shards then
differ only in rounding: float64 at ``chip_smoke.DEMO_RTOL`` (1e-9), and one
float32 case, the script's own dtype, at about three times the gaps measured
here (``F32_RTOL``).  Both packages are handed ``chip_smoke.demo_probe``'s
probes: the JAX shards each draw their (16, 500) block alike, and each rank's
draw is that block tiled over its 2000 rows (``chip_smoke.DemoProbes``).
"""

import os
import sys

import numpy as np
import torch

import chip_smoke as cs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_demos as td  # noqa: E402

torch.set_num_threads(1)

NAME = "demo_sharded"
# float32 against float32, relative to the largest entry; about three times
# the gaps measured here (NLMLs 2.5e-6 / 1.3e-5, rmse 3.5e-4, SKI NLML
# 1.0e-6, its means 2.4e-5 and variances 4.7e-2: each variance is a small
# difference of float32 terms).
F32_RTOL = {"ll_init": 7.5e-6, "ll": 4e-5, "rmse": 1e-3, "ski_ll": 3e-6, "ski_mean": 7e-5, "ski_var": 0.15}


def test_demo_matches_jax():
    got = td.port_values(NAME, block=cs.DEMO_SHARD_BLOCK)
    td.assert_matches(NAME, got, td.jax_values(NAME))
    assert got["devices"] == ["cpu", "cpu"] and got["rows"] == [2000, 2000]
    assert len(set(got["ski_ll_ranks"])) == 1
    assert got["ll"] > got["ll_init"] and got["mean_finite"] and min(got["ski_var"]) >= 0
    assert got["launches"] == {k: 0 for k in ("K1", "K2", "K3", "K4", "K5")}


def test_demo_matches_jax_float32():
    got = td.port_values(NAME, block=cs.DEMO_SHARD_BLOCK, dtype="float32")
    td.assert_matches(NAME, got, td.jax_values(NAME, dtype="float32"), rtol=F32_RTOL)


def test_jax_demos_record_is_the_tool():
    td.assert_record(NAME, td.jax_values(NAME))


def test_tool_is_the_script():
    """At the script's own dtype (float32): DEMO_CPU_ARGS holds only float64."""
    out = td.jax_stdout(NAME)
    assert td.ref.masked(out) == td.ref.masked("\n".join(td.ref.lines_sharded(td.jax_values(NAME, dtype="float32"))))


def test_main_prints_the_script_labels(monkeypatch, capsys):
    td.assert_main(NAME, monkeypatch, capsys, td.port_values(NAME, block=cs.DEMO_SHARD_BLOCK),
                   ["--device", "cpu", "--world", "2"], td.jax_stdout(NAME), world=2, device="cpu")


def test_main_needs_a_card():
    td.assert_main_needs_a_card(NAME)


def test_probes_tile_the_shards_block():
    probes = cs.DemoProbes(block=cs.DEMO_SHARD_BLOCK)
    z = probes((16, 2000), dtype=torch.float64, device="cpu", generator=None).numpy()
    block = cs.demo_probe((16, cs.DEMO_SHARD_BLOCK))
    assert np.array_equal(z, np.tile(block, (1, 4))) and set(np.unique(block)) == {-1.0, 1.0}
    assert np.array_equal(probes((16, 500), dtype=torch.float64, device="cpu", generator=None).numpy(), block)
