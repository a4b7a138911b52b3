"""The port's config runner (``gp_grief_tpu_torch.run_configs``) against the
JAX package's, float64 on the CPU, at the configurations' full sizes (none
is cut: sine1d n = 1000, grid3d 22³, d100 n = 1000 at d = 100).

The JAX side is ``benchmarks/run_configs.py``'s own functions, run through
``tools/configs_reference_jax.py`` (unrounded values, and sine1d's trained
NLMLs).  The limits are chip_smoke.py's (``CONFIG_RTOL``,
``SINE1D_PARITY_MAX``), the ones its ``configs`` phase holds the card to;
the values it holds the card to (``JAX_CONFIGS``) must be these.
"""

import json

import pytest
import torch

import chip_smoke as cs
from gp_grief_tpu_torch import run_configs as rc
from tools import configs_reference_jax as jref

torch.set_num_threads(1)

EXTRAS = {"nlml_grief", "nlml_exact"}  # the reference tool's additions to the line


@pytest.mark.parametrize("name", ["sine1d", "grid3d", "d100"])
def test_config_matches_jax(name):
    want = jref.run(name)
    got = rc.ALL[name](device="cpu")
    assert rc.KEYS[name] == tuple(k for k in want if k not in EXTRAS)
    line = json.loads(rc.line(name, got))
    assert list(line) == ["config", *rc.KEYS[name]] and line["config"] == name
    for key, ref in cs.JAX_CONFIGS[name].items():
        assert ref == pytest.approx(want[key], rel=1e-12), f"chip_smoke.JAX_CONFIGS[{name!r}][{key!r}]"
        if key in cs.CONFIG_RTOL:
            assert got[key] == pytest.approx(want[key], rel=cs.CONFIG_RTOL[key]), key
    if name == "sine1d":
        for key, limit in cs.SINE1D_PARITY_MAX.items():
            assert got[key] <= limit, key
    if name == "d100":
        assert got["pred_finite"] and got["virtual_pts_log10"] == want["virtual_pts_log10"] == 100.0
    if name == "grid3d":
        assert got["n"] == want["n"] == 22**3


def test_runner_rejects_an_unknown_config(capsys):
    with pytest.raises(SystemExit):
        rc.main(["sine2d", "--device", "cpu"])
    assert "unknown configurations ['sine2d']" in capsys.readouterr().err
