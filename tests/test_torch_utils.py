"""The port's utilities and command line on the CPU (tests/test_utils.py:17-100's
cases): checkpoints that cross between the two packages, resumed training,
the metric logger, the finiteness guards, profiling spans, and
``python -m gp_grief_tpu_torch {checkgrad,configs,bench}`` as subprocesses."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
from gp_grief_tpu.utils import load_pytree as jload
from gp_grief_tpu.utils import save_pytree as jsave
from gp_grief_tpu_torch.optimize import fit
from gp_grief_tpu_torch.utils import MetricLogger, check_finite, guarded, load_pytree, save_pytree, timed, trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grief_pair():
    """A two-dimensional GRIEF model with trained kernel hyperparameters in
    each package, from the same data."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(80, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(80)
    kw = dict(n_eigs=12, mbar=8, noise_var=0.1, opt_kernel_params=True)
    jm = gpx.GPGriefModel(x, y, [gpx.make_kernel("rbf", lengthscale=0.5) for _ in range(2)], **kw)
    tm = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.5) for _ in range(2)], device="cpu", **kw)
    return jm, tm


def test_checkpoint_crosses_between_the_packages(tmp_path):
    """A JAX checkpoint loads into the port's model, and the port's into the
    JAX model, under the same keys (``kernels/0/log_lengthscale``, …), each
    giving the same NLML."""
    jm, tm = _grief_pair()
    jm.optimize(optimizer="adam", max_iters=5, learning_rate=0.1)
    path = str(tmp_path / "jax.npz")
    jsave(path, jm.params)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(k.replace(".", "/") for k in tm.state_dict())
    tm.load_state_dict(load_pytree(path, tm))
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-12)

    tm.optimize(optimizer="adam", max_iters=3, learning_rate=0.1)
    path = str(tmp_path / "port.npz")
    save_pytree(path, tm)
    jm.params = jload(path, jm.params)
    np.testing.assert_array_equal(jm.parameters, tm.parameters)
    assert jm.log_likelihood() == pytest.approx(tm.log_likelihood(), rel=1e-12)


def test_checkpoint_round_trip_keeps_structure_and_types(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"log_w": torch.as_tensor(rng.standard_normal(5), dtype=torch.float32),
            "nested": {"a": torch.tensor(2.5, dtype=torch.float64), "ks": [torch.ones((2, 2)), np.zeros(3)]},
            "meta": (0.05, True, 7, "adam", None)}
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, tree)
    like = {"log_w": torch.zeros(5, dtype=torch.float32),
            "nested": {"a": torch.tensor(0.0, dtype=torch.float64), "ks": [torch.zeros((2, 2)), np.ones(3)]},
            "meta": (0.0, False, 0, "", None)}
    back = load_pytree(path, like)
    assert torch.equal(back["log_w"], tree["log_w"]) and back["log_w"].dtype == torch.float32
    assert torch.equal(back["nested"]["a"], tree["nested"]["a"])
    assert torch.equal(back["nested"]["ks"][0], tree["nested"]["ks"][0])
    np.testing.assert_array_equal(back["nested"]["ks"][1], tree["nested"]["ks"][1])
    assert back["meta"] == (0.05, True, 7, "adam", None) and isinstance(back["meta"], tuple)
    with pytest.raises(KeyError, match="missing leaf"):
        load_pytree(path, {"other": torch.zeros(1)})


def test_fit_resume_matches_uninterrupted(tmp_path):
    """fit(n) + fit(m, opt_state=restored) reproduces fit(n + m) exactly,
    the parameters and the Adam state through the ``.npz`` checkpoint."""
    rng = np.random.default_rng(2)
    A = torch.as_tensor(rng.standard_normal((6, 3)))
    b = torch.as_tensor(rng.standard_normal(6))
    w = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))

    def loss():
        r = A @ w - b
        return torch.dot(r, r) + 0.1 * torch.sum(w**2)

    kw = dict(optimizer="adam", learning_rate=0.1, tol=0.0)
    full = fit(loss, [("w", w)], max_iters=12, **kw)
    w_full = w.detach().clone()
    with torch.no_grad():
        w.zero_()
    half = fit(loss, [("w", w)], max_iters=6, **kw)
    path = str(tmp_path / "ck.npz")
    save_pytree(path, {"params": {"w": w}, "opt": half.opt_state})
    with torch.no_grad():
        w.fill_(123.0)
    restored = load_pytree(path, {"params": {"w": w.detach()}, "opt": half.opt_state})
    with torch.no_grad():
        w.copy_(restored["params"]["w"])
    resumed = fit(loss, [("w", w)], max_iters=6, opt_state=restored["opt"], **kw)
    assert torch.equal(w.detach(), w_full)
    np.testing.assert_array_equal(np.concatenate([half.losses, resumed.losses]), full.losses)


def test_metric_logger(tmp_path, capsys):
    path = str(tmp_path / "metrics.jsonl")
    with MetricLogger(path, echo=True) as log:
        log.log(step=1, nlml=3.5)
        log.log(step=2, nlml=2.5, cg_iters=7)
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["step"] == 1 and lines[1]["cg_iters"] == 7
    assert all("t" in line for line in lines)
    assert len(capsys.readouterr().err.splitlines()) == 2


def test_guarded_catches_nonfinite():
    bad = guarded(lambda x: torch.log(x))  # -inf at 0
    with pytest.raises(FloatingPointError, match="non-finite values in output"):
        bad(torch.tensor(0.0))
    assert float(guarded(lambda x: x * 2)(torch.tensor(3.0))) == 6.0
    with pytest.raises(FloatingPointError, match="in tuple"):
        guarded(lambda x: check_finite(x[1], "tuple") or x, check_output=False)((torch.ones(2), torch.tensor(np.nan)))
    with pytest.raises(FloatingPointError):
        guarded(lambda: {"a": [1.0, np.array([np.inf])]})()
    assert guarded(lambda: (torch.arange(3), "text"))()[1] == "text"


def test_timed_and_trace_on_the_cpu(tmp_path, capsys):
    results = {}
    with timed("matmul", results):
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert results["matmul"] > 0
    with timed("printed"):
        pass
    assert capsys.readouterr().out.startswith("[timed] printed:")
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        torch.ones((32, 32)) @ torch.ones((32, 32))
    files = os.listdir(logdir)
    assert len(files) == 1 and os.path.getsize(os.path.join(logdir, files[0])) > 0
    assert "traceEvents" in json.load(open(os.path.join(logdir, files[0])))


def _cli(*args):
    """Run ``python -m gp_grief_tpu_torch`` with ``args`` in a fresh
    interpreter on one thread; fail if it imported jax."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['gp_grief_tpu_torch', *{list(args)!r}]\n"
            "try:\n"
            "    runpy.run_module('gp_grief_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "assert 'jax' not in sys.modules, 'the command line imported jax'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_checkgrad_and_configs():
    out = _cli("checkgrad", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "OK" and "param[ 16]" in out.stdout
    out = _cli("configs", "sine1d", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["config"] == "sine1d" and np.isfinite(line["rmse"])
    # bench with no CUDA device and no --device raises (exit 1); a usage error exits 2.
    for args, rc in ((("checkgrad", "--sample", "x", "--device", "cpu"), 2), (("bench",), 1),
                     (("bench", "--d", "x"), 2), (("nonsense",), 2), ((), 0)):
        assert _cli(*args).returncode == rc
