"""The port's real-dataset hook (``gp_grief_tpu_torch.data`` and
``run_configs.kin40k_split`` / ``uci2m_split``) against the JAX side's
(``benchmarks/data.py``, ``benchmarks/run_configs.py``), with small files
the tests write themselves (the cases of tests/test_data_loaders.py).

Every loader case returns the same arrays as ``benchmarks.data``, bit for
bit, or raises the same ``ValueError``; a dropped file gives the ``*_real``
tag and the arrays the JAX config computes from it, bit for bit; with no
file the synthetic sets run as before.  The end-to-end ``configs kin40k`` /
``configs uci2m`` runs on a dropped file take ~10 s each on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmarks import data as jdata
from gp_grief_tpu_torch import data as tdata
from gp_grief_tpu_torch import run_configs as rc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kin40k_npz(root, n_tr=20, n_te=8, d=8, seed=0, **override):
    rng = np.random.default_rng(seed)
    arrays = dict(x_train=rng.standard_normal((n_tr, d)), y_train=rng.standard_normal(n_tr),
                  x_test=rng.standard_normal((n_te, d)), y_test=rng.standard_normal(n_te))
    arrays.update(override)
    np.savez(os.path.join(root, "kin40k.npz"), **{k: v for k, v in arrays.items() if v is not None})


def _kin40k_asc(root):
    rng = np.random.default_rng(1)
    parts = {"train_data": rng.standard_normal((12, 8)), "train_labels": rng.standard_normal((12, 1)),
             "test_data": rng.standard_normal((5, 8)), "test_labels": rng.standard_normal(5)}
    for name, arr in parts.items():
        np.savetxt(os.path.join(root, f"kin40k_{name}.asc"), arr)


def _uci2m_npz(root, n=50, y_rows=None, y=True):
    rng = np.random.default_rng(3)
    arrays = {"x": rng.standard_normal((n, 4))}
    if y:
        arrays["y"] = rng.standard_normal((n if y_rows is None else y_rows, 1))
    np.savez(os.path.join(root, "uci2m.npz"), **arrays)


# tests/test_data_loaders.py's cases: absent, the npz and the 4-file ASCII
# kin40k, uci2m's npz, and each malformed file it checks.
CASES = {
    "absent": lambda root: None,
    "kin40k_npz": _kin40k_npz,
    "kin40k_asc": _kin40k_asc,
    "kin40k_label_rows": lambda root: _kin40k_npz(root, seed=2, y_train=np.zeros(19)),
    "kin40k_missing": lambda root: _kin40k_npz(root, y_train=None, x_test=None, y_test=None),
    "kin40k_feature_dims": lambda root: _kin40k_npz(root, x_test=np.zeros((8, 7))),
    "kin40k_1d_x": lambda root: _kin40k_npz(root, x_train=np.zeros(20)),
    "uci2m_npz": _uci2m_npz,
    "uci2m_y_rows": lambda root: _uci2m_npz(root, y_rows=49),
    "uci2m_missing": lambda root: _uci2m_npz(root, y=False),
    "uci2m_few_rows": lambda root: _uci2m_npz(root, n=5),
}


def _call(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "ValueError", str(e)


def _same(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] != "ok" or want[1] is None:
        assert got[1] == want[1]
        return
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("via_env", [False, True], ids=["root", "GP_GRIEF_DATA"])
@pytest.mark.parametrize("case", list(CASES))
def test_loaders_match_benchmarks_data(case, via_env, tmp_path, monkeypatch):
    """Both loaders, float32 and float64, given the directory or through
    ``$GP_GRIEF_DATA``: the same arrays bit for bit, or the same error."""
    CASES[case](str(tmp_path))
    if via_env:
        monkeypatch.setenv("GP_GRIEF_DATA", str(tmp_path))
        kw = {}
    else:
        kw = {"root": str(tmp_path)}
    for name in ("load_kin40k", "load_uci2m"):
        for dtype in (np.float32, np.float64):
            want = _call(getattr(jdata, name), dtype=dtype, **kw)
            _same(_call(getattr(tdata, name), dtype=dtype, **kw), want)
    if case != "absent":
        which = "load_kin40k" if case.startswith("kin40k") else "load_uci2m"
        assert _call(getattr(tdata, which), **kw) != ("ok", None)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_standardize_matches(dtype):
    """Training-split statistics only; the same bits as benchmarks.data's."""
    rng = np.random.default_rng(4)
    xt = (3.0 + 2.0 * rng.standard_normal((200, 3))).astype(dtype)
    yt = (-1.0 + 0.5 * rng.standard_normal(200)).astype(dtype)
    xe, ye = rng.standard_normal((50, 3)).astype(dtype), rng.standard_normal(50).astype(dtype)
    got, want = tdata.standardize(xt, yt, xe, ye), jdata.standardize(xt, yt, xe, ye)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[4] == want[4]
    np.testing.assert_allclose(got[2], (xe - xt.mean(0)) / (xt.std(0) + 1e-12), rtol=0)


def test_default_directory_is_shared(monkeypatch):
    """Without $GP_GRIEF_DATA both packages read <repository>/benchmarks/data."""
    monkeypatch.delenv("GP_GRIEF_DATA", raising=False)
    assert os.path.realpath(tdata.data_dir()) == os.path.realpath(jdata.data_dir())
    assert os.path.realpath(tdata.data_dir()) == os.path.join(os.path.realpath(ROOT), "benchmarks", "data")


def _jax_kin40k_split():
    """benchmarks/run_configs.py:132-138 on the loader's output (float32)."""
    dtype = np.float32
    real = jdata.load_kin40k(dtype=dtype)
    xtr, ytr, xte, yte, _ = jdata.standardize(*real)
    xtr, ytr, xte, yte = (np.asarray(a, dtype=dtype) for a in (xtr, ytr, xte, yte))
    return "kin40k_real", xtr, ytr, xte, yte, yte


def _jax_uci2m_split():
    """benchmarks/run_configs.py:185-204 on the loader's output."""
    dtype = np.float32
    x, y = jdata.load_uci2m(dtype=dtype)
    xm, xs = x.mean(0), x.std(0) + 1e-12
    ym, ys = y.mean(), y.std() + 1e-12
    x, y = ((x - xm) / xs).astype(dtype), ((y - ym) / ys).astype(dtype)
    n = x.shape[0]
    f = y
    n_te = min(100_000, max(1, n // 5))
    return "uci2m_real", x[:-n_te], y[:-n_te], x[-n_te:], f[-n_te:]


@pytest.mark.parametrize("which", ["kin40k_npz", "kin40k_asc", "uci2m_npz"])
def test_split_takes_a_dropped_file(which, tmp_path, monkeypatch):
    CASES[which](str(tmp_path))
    monkeypatch.setenv("GP_GRIEF_DATA", str(tmp_path))
    got = rc.kin40k_split() if which.startswith("kin40k") else rc.uci2m_split()
    want = _jax_kin40k_split() if which.startswith("kin40k") else _jax_uci2m_split()
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape and np.array_equal(g, w)


def test_split_without_a_file_is_synthetic(tmp_path, monkeypatch):
    """No file: the synthetic sets, as kin40k_data() / uci2m_data() give
    them (uci2m_data stubbed: its 2M rows are not what is checked)."""
    monkeypatch.setenv("GP_GRIEF_DATA", str(tmp_path))
    tag, *arrays = rc.kin40k_split()
    assert tag == "kin40k_synth"
    for g, w in zip(arrays, rc.kin40k_data(), strict=True):
        assert np.array_equal(g, w)
    stub = tuple(np.full(3, float(i)) for i in range(4))
    monkeypatch.setattr(rc, "uci2m_data", lambda: stub)
    assert rc.uci2m_split() == ("uci2m_synth", *stub)


def _configs(name, data_dir):
    env = dict(os.environ, GP_GRIEF_DATA=str(data_dir), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "gp_grief_tpu_torch", "configs", name, "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_kin40k_config_runs_on_a_dropped_file(tmp_path):
    """tests/test_data_loaders.py's kin40k drop (400 / 80 rows, d = 4)
    through the port's command line: the kin40k_real recipe end to end."""
    rng = np.random.default_rng(0)
    n_tr, n_te, d = 400, 80, 4
    x = rng.uniform(-1, 1, size=(n_tr + n_te, d))
    y = np.sin(2 * x[:, 0]) + 0.5 * x[:, 1] * x[:, 2] + 0.05 * rng.standard_normal(len(x))
    np.savez(os.path.join(str(tmp_path), "kin40k.npz"), x_train=x[:n_tr], y_train=y[:n_tr], x_test=x[n_tr:],
             y_test=y[n_tr:])
    rec = _configs("kin40k", tmp_path)
    assert rec["config"] == "kin40k_real" and (rec["n"], rec["d"]) == (n_tr + n_te, d)
    assert list(rec) == ["config", *rc.KEYS["kin40k"]]
    assert np.isfinite(rec["rmse"]) and np.isfinite(rec["nll"])


def test_uci2m_config_runs_on_a_dropped_file(tmp_path):
    """tests/test_data_loaders.py's uci2m drop (3000 rows, d = 4): the
    proportional split, training and the iterative NLML against the closed
    form (its limit there, 0.05)."""
    rng = np.random.default_rng(1)
    n, d = 3000, 4
    x = rng.uniform(-1, 1, size=(n, d))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    np.savez(os.path.join(str(tmp_path), "uci2m.npz"), x=x, y=y)
    rec = _configs("uci2m", tmp_path)
    assert rec["config"] == "uci2m_real" and (rec["n"], rec["d"]) == (n, d)
    assert list(rec) == ["config", *rc.KEYS["uci2m"]]
    assert np.isfinite(rec["rmse"]) and np.isfinite(rec["nlml_closed"])
    assert rec["slq_cg_nlml_gap"] < 0.05
