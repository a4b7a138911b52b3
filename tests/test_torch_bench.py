"""``python -m gp_grief_tpu_torch bench`` on the CPU, against the
repository's ``bench.py`` (the JAX package's headline benchmark).

The port's factors are ``bench.py``'s NumPy draw bit for bit; one
"default" application (the chain, on the CPU) is held to the JAX package's
``kron_matvec_fast`` at ``Precision.DEFAULT``; the command's JSON line has
``bench.py``'s keys less the departures listed here; the card-only checks
(K2's route and launch counts at 5 × 32) are exercised where the CPU can
reach them.  The card runs the command in ``chip_smoke.py``'s phase 16.
"""

import io
import json
import math
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from gp_grief_tpu.ops import kron_matvec_fast as jkron_matvec_fast
from gp_grief_tpu_torch import bench
from gp_grief_tpu_torch.ops.cuda.kron import kron_matvec_slab
from gp_grief_tpu_torch.ops.kron_fast import kernel_route

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py's detail keys the port renames: the TPU's error figure leaves the
# x3 key (the port prints its measured error beside it), and the target is
# 0.7 x this run's stream (no TPU reference stream).
RENAMED = {"x3_grade_GBs(rel~4e-6)": "x3_grade_GBs", "target_GBs(0.7xstream_ref)": "target_GBs(0.7xstream)"}
# bench.py's detail keys the port drops: the TPU's best stream (the
# denominator's clamp) and the per-phase subprocess note.
DROPPED = {"stream_ref_GBs", "phases"}


def _cli(*args):
    """``python -m gp_grief_tpu_torch bench ...`` in a fresh interpreter on
    one thread; fails if it imported jax."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['gp_grief_tpu_torch', 'bench', *{list(args)!r}]\n"
            "try:\n"
            "    runpy.run_module('gp_grief_tpu_torch', run_name='__main__')\n"
            "    rc = 0\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "assert 'jax' not in sys.modules, 'bench imported jax'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def _json_lines(text: str) -> list:
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def _bench_py_record() -> dict:
    """The line ``bench.py``'s ``main`` prints, its phases stubbed (only
    its keys are read)."""
    stub = {"ok": True, "gbs": 1.0, "ms": 1.0}
    launch = jbench._launch_phase
    jbench._launch_phase = lambda *a, **k: stub
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            jbench.main(d=3, m_d=4)
    finally:
        jbench._launch_phase = launch
    return json.loads(buf.getvalue().splitlines()[-1])


@pytest.mark.parametrize("d,m_d", [(3, 8), (5, 32)])
def test_factors_are_bench_py_draw(d, m_d):
    """Bit for bit: the same NumPy draw, cast to float32 the same way."""
    _, want, _, _ = jbench._phase_setup(d, m_d)
    got = bench.bench_factors(d, m_d, "cpu")
    assert len(got) == d
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32
        assert np.array_equal(g.numpy(), w)


def test_default_application_matches_jax():
    """One matvec-phase application at (d = 3, m_d = 8) on the CPU against
    the JAX package's kron_matvec_fast at Precision.DEFAULT on the same
    NumPy vector.  The port's chain rounds its 512-wide pass's operands to
    bf16 (the grade), XLA's CPU dot ignores DEFAULT: the two sit in the bf16
    class of each other (2e-2, relative in norm)."""
    factors = bench.bench_factors(3, 8, "cpu")
    v = np.random.default_rng(1).standard_normal(8**3).astype(np.float32)
    step, route = bench.matvec_step(factors, torch.as_tensor(v))
    assert route == "chain"
    got = step(torch.as_tensor(v)).numpy()
    want = np.asarray(jkron_matvec_fast([jnp.asarray(K.numpy()) for K in factors], jnp.asarray(v),
                                        precision=jax.lax.Precision.DEFAULT))
    assert got.dtype == np.float32 and got.shape == want.shape
    rel = np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want)
    assert rel < 2e-2
    err = bench._rel_err(torch.as_tensor(got), factors, torch.as_tensor(v))
    assert 1e-5 < err <= bench.REL_ERR_MAX["default"]  # the bf16 grade, not the exact one


def test_default_operating_point_is_k2():
    """At 5 x 32 a float32 vector on the card routes to K2, whose plan is two
    tile passes (the exact grade runs both on its exact tile member); off
    the card the x3 phase is skipped."""
    factors = bench.bench_factors(5, 32, "cpu")
    assert kernel_route(factors, 1, "default", vector_dtype=torch.float32) == "slab"
    assert bench._plan(factors) == (2, 2)
    assert bench.x3_step(factors, torch.zeros(32**5)) == "skipped(device=cpu)"


def test_launch_check(monkeypatch):
    """An application that launches other than the plan's passes raises."""
    monkeypatch.setattr(kron_matvec_slab, "launches", 0)
    monkeypatch.setattr(kron_matvec_slab, "exact_tile_launches", 0)

    def launch(passes, exact):
        def apply(x):
            kron_matvec_slab.launches += passes
            kron_matvec_slab.exact_tile_launches += exact
            return x
        return apply

    assert bench._counted(launch(2, 2), 2, 2)(3) == 3
    for passes, exact in ((1, 1), (2, 0), (3, 2)):
        with pytest.raises(RuntimeError, match="K2 passes"):
            bench._counted(launch(passes, exact), 2, 2)(3)


def test_cli_on_the_cpu():
    out = _cli("--d", "3", "--m_d", "8", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads(out.stdout.splitlines()[-1])
    want = _bench_py_record()
    assert set(rec) == set(want)
    detail_keys = {RENAMED.get(k, k) for k in want["detail"]} - DROPPED
    assert detail_keys <= set(rec["detail"]), detail_keys - set(rec["detail"])
    assert (rec["metric"], rec["unit"]) == (want["metric"], want["unit"])
    det = rec["detail"]
    assert det["shape"] == "(kron 3x8^2)·v, m=512" and det["route"] == "chain" and det["device"] == "cpu"
    for key in ("x3_grade_GBs", "x3_ms", "x3_rel_err"):
        assert det[key] == "skipped(device=cpu)"
    for value in (rec["value"], det["stream_GBs"], det["matvec_ms"], det["stream_ms"]):
        assert math.isfinite(value) and value > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / (0.7 * det["stream_GBs"]), rel=1e-12)
    assert det["target_GBs(0.7xstream)"] == pytest.approx(0.7 * det["stream_GBs"], rel=1e-12)
    assert det["matvec_rel_err"] <= det["matvec_rel_err_max"] == bench.REL_ERR_MAX["default"]
    assert det["busy_share"] == {"matvec": None, "stream": None, "x3": None}  # a device metric: not on the CPU
    assert det["launches"] == {"matvec": 0, "x3": 0, "x3_exact_tile": 0}


def test_cli_needs_a_card_or_device_cpu():
    """With no CUDA device and no --device the command raises before any
    work and prints no result; a usage error exits 2."""
    if torch.cuda.is_available():
        pytest.skip("this case needs a machine without a CUDA device")
    out = _cli()
    assert out.returncode not in (0, 2)
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert _json_lines(out.stdout) == []
    for args in (("--d", "x"), ("--m_d",), ("--d", "0"), ("--nonsense", "1")):
        out = _cli(*args)
        assert out.returncode == 2, (args, out.stdout, out.stderr)
        assert _json_lines(out.stdout) == []
