"""Inducing-grid construction (host-side NumPy — data-dependent shapes).

A copy of ``gp_grief_tpu.grid`` (which cannot be imported here: the JAX
package's ``__init__`` imports jax).  Build a Cartesian product grid of
inducing points from training data, one 1D point set per dimension.  Per
dimension with budget ``mbar``: if the data has ≤ ``mbar`` unique values, use
them verbatim (then on-grid data stays exactly on-grid); otherwise place
``mbar`` points either equispaced over the (slightly padded) data range or at
1D k-means centers.

This runs once, before training, with data-dependent output shapes, so it
stays in host NumPy; the models copy the per-dimension arrays to their device
and dtype.  The 1D k-means is a ~15-line Lloyd iteration rather than an
sklearn dependency.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

__all__ = ["InducingGrid"]


def _kmeans_1d(x: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    """Lloyd's algorithm in 1D with quantile initialization."""
    centers = np.quantile(x, (np.arange(k) + 0.5) / k)
    for _ in range(iters):
        # Assign by nearest center (1D: via sorted boundaries).
        boundaries = (centers[1:] + centers[:-1]) / 2.0
        assign = np.searchsorted(boundaries, x)
        sums = np.bincount(assign, weights=x, minlength=k)
        counts = np.bincount(assign, minlength=k)
        new = np.where(counts > 0, sums / np.maximum(counts, 1), centers)
        if np.allclose(new, centers):
            break
        centers = new
    return np.sort(centers)


def _kmeans_nd(x: np.ndarray, k: int, iters: int = 25, seed: int = 0) -> np.ndarray:
    """Lloyd's algorithm for multi-column grid dimensions (sub_dim > 1)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=k, replace=False)]
    for _ in range(iters):
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(axis=1)
        new = np.stack(
            [
                x[assign == j].mean(axis=0) if np.any(assign == j) else centers[j]
                for j in range(k)
            ]
        )
        if np.allclose(new, centers):
            break
        centers = new
    return centers


@dataclasses.dataclass(frozen=True)
class InducingGrid:
    """Cartesian inducing grid: per-dim point arrays ``xg[d]`` of shape ``(m_d, 1)``.

    Attributes mirror the reference (``grid_shape``, ``grid_dim``, ``xg``,
    ``num_data``, ``input_dim`` — SURVEY.md §2 #14).
    """

    xg: Tuple[np.ndarray, ...]
    grid_shape: Tuple[int, ...]
    input_dim: int
    num_data: int

    @property
    def grid_dim(self) -> int:
        return len(self.xg)

    @property
    def num_virtual(self) -> float:
        """Π m_d as a float (can exceed 10^100 — use logs for exact work)."""
        return float(np.exp(sum(math.log(m) for m in self.grid_shape)))

    @property
    def log10_num_virtual(self) -> float:
        return sum(math.log10(m) for m in self.grid_shape)

    dims: Tuple[Tuple[int, ...], ...] = None  # input columns per grid dim

    @classmethod
    def build(
        cls,
        x: np.ndarray,
        mbar: int | Sequence[int] = 10,
        eq: bool = True,
        pad: float = 0.05,
        seed: int = 0,
        dims: Sequence[Sequence[int]] | None = None,
    ) -> "InducingGrid":
        """Construct from data ``x`` of shape ``(n, d)``.

        Args:
          mbar: per-grid-dimension point budget (scalar or one per grid dim).
          eq: equispaced placement when the unique values exceed the budget;
            ``False`` selects k-means centers instead (the reference's two
            placement modes).
          pad: relative range padding for equispaced placement.
          dims: optional grouping of input columns into grid dimensions (the
            reference's ``sub_dim`` capability: ``xg[d]`` of shape
            ``(m_d, sub_dim)``).  Default: one grid dim per input column.
            Multi-column groups always use k-means placement.
        """
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        n, d = x.shape
        groups = (
            tuple(tuple(int(c) for c in g) for g in dims)
            if dims is not None
            else tuple((c,) for c in range(d))
        )
        covered = sorted(c for g in groups for c in g)
        if covered != list(range(d)):
            raise ValueError(f"dims must cover every input column exactly once, got {groups}")
        ng = len(groups)
        mbars = [int(mbar)] * ng if np.isscalar(mbar) else [int(m) for m in mbar]
        if len(mbars) != ng:
            raise ValueError(f"mbar must be scalar or length {ng} (one per grid dim)")
        xg = []
        for gi, cols in enumerate(groups):
            sub = x[:, list(cols)]
            if len(cols) == 1:
                col = sub[:, 0]
                uniq = np.unique(col)
                if uniq.size <= mbars[gi]:
                    pts = uniq[:, None]
                elif eq:
                    lo, hi = col.min(), col.max()
                    span = hi - lo
                    pts = np.linspace(lo - pad * span, hi + pad * span, mbars[gi])[:, None]
                else:
                    pts = _kmeans_1d(col, mbars[gi], seed=seed)[:, None]
            else:
                uniq = np.unique(sub, axis=0)
                pts = uniq if len(uniq) <= mbars[gi] else _kmeans_nd(sub, mbars[gi], seed=seed)
            xg.append(pts)
        return cls(
            xg=tuple(xg),
            grid_shape=tuple(int(g.shape[0]) for g in xg),
            input_dim=d,
            num_data=n,
            dims=groups,
        )
