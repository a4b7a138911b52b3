"""Real-dataset loaders for the kin40k and uci2m configurations.

Counterpart of ``benchmarks/data.py``: the same file names, layouts, dtypes
and errors.  When the real files are in ``<repository>/benchmarks/data/``
(the directory the JAX package's loaders read, so one drop serves both
packages) or in a directory named by ``$GP_GRIEF_DATA``,
``gp_grief_tpu_torch.run_configs`` runs kin40k and uci2m on them in place of
the synthetic sets.

Layouts:

kin40k:
  - ``kin40k.npz`` with arrays ``x_train, y_train, x_test, y_test``; or
  - the 4-file ASCII export: ``kin40k_train_data.asc``,
    ``kin40k_train_labels.asc``, ``kin40k_test_data.asc``,
    ``kin40k_test_labels.asc``.

uci2m (a large UCI regression set, such as HouseElectric):
  - ``uci2m.npz`` with arrays ``x, y`` (intended for n >= 1e6 rows).

NumPy only.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["data_dir", "load_kin40k", "load_uci2m", "standardize"]


def data_dir() -> str:
    """``$GP_GRIEF_DATA``, else the repository's ``benchmarks/data``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.environ.get("GP_GRIEF_DATA", os.path.join(repo, "benchmarks", "data"))


def standardize(
    x_train: np.ndarray, y_train: np.ndarray, x_test: np.ndarray, y_test: np.ndarray
):
    """Per-feature zero mean and unit variance on x, zero mean and unit
    variance on y, with statistics from the training split only (the
    paper's protocol).  Returns the four arrays and y's scale."""
    xm, xs = x_train.mean(0), x_train.std(0) + 1e-12
    ym, ys = y_train.mean(), y_train.std() + 1e-12
    return (
        (x_train - xm) / xs,
        (y_train - ym) / ys,
        (x_test - xm) / xs,
        (y_test - ym) / ys,
        float(ys),
    )


def _check_split(x_train, y_train, x_test, y_test, what: str):
    """Raise ``ValueError`` on a malformed split at load time, before a
    config run would meet it."""
    if x_train.ndim != 2 or x_test.ndim != 2:
        raise ValueError(
            f"{what}: x splits must be 2-D (n, d); got "
            f"{x_train.shape} / {x_test.shape}"
        )
    if x_train.shape[1] != x_test.shape[1]:
        raise ValueError(
            f"{what}: train/test feature dims differ: "
            f"{x_train.shape[1]} vs {x_test.shape[1]}"
        )
    if y_train.shape != (x_train.shape[0],) or y_test.shape != (x_test.shape[0],):
        raise ValueError(
            f"{what}: labels must be 1-D matching their x rows; got "
            f"y_train {y_train.shape} for x_train {x_train.shape}, "
            f"y_test {y_test.shape} for x_test {x_test.shape}"
        )
    return x_train, y_train, x_test, y_test


def load_kin40k(
    root: Optional[str] = None, dtype=np.float32
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Return ``(x_train, y_train, x_test, y_test)`` or ``None`` if absent."""
    root = root or data_dir()
    npz = os.path.join(root, "kin40k.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        missing = [k for k in ("x_train", "y_train", "x_test", "y_test") if k not in z]
        if missing:
            raise ValueError(f"kin40k.npz: missing arrays {missing}")
        xt, yt, xe, ye = (
            np.asarray(z[k], dtype=dtype)
            for k in ("x_train", "y_train", "x_test", "y_test")
        )
        return _check_split(xt, yt.reshape(-1), xe, ye.reshape(-1), "kin40k.npz")
    asc = [
        os.path.join(root, f"kin40k_{s}.asc")
        for s in ("train_data", "train_labels", "test_data", "test_labels")
    ]
    if all(os.path.exists(p) for p in asc):
        xt, yt, xe, ye = (np.loadtxt(p) for p in asc)
        return _check_split(
            np.asarray(xt, dtype=dtype),
            np.asarray(yt, dtype=dtype).reshape(-1),
            np.asarray(xe, dtype=dtype),
            np.asarray(ye, dtype=dtype).reshape(-1),
            "kin40k .asc files",
        )
    return None


def load_uci2m(
    root: Optional[str] = None, dtype=np.float32
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Return ``(x, y)`` or ``None`` if absent."""
    root = root or data_dir()
    npz = os.path.join(root, "uci2m.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        missing = [k for k in ("x", "y") if k not in z]
        if missing:
            raise ValueError(f"uci2m.npz: missing arrays {missing}")
        x = np.asarray(z["x"], dtype=dtype)
        y = np.asarray(z["y"], dtype=dtype).reshape(-1)
        if x.ndim != 2 or y.shape != (x.shape[0],):
            raise ValueError(
                f"uci2m.npz: need x (n, d) and matching y (n,); got "
                f"x {x.shape}, y {np.asarray(z['y']).shape}"
            )
        if x.shape[0] < 10:
            # A file this small would leave the config an empty training
            # split; say so here rather than deep inside the run.
            raise ValueError(
                f"uci2m.npz: only {x.shape[0]} rows — need at least 10 "
                "(intended for n >= 1e6 datasets)"
            )
        return x, y
    return None
