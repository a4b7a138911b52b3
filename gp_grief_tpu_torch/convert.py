"""Carry parameters and bases from the JAX package into the port.

The JAX package's parameters are a pytree whose leaves have dotted names
(``kernels.0.log_lengthscale``, …, ``log_noise``, ``log_w`` for GP-GRIEF;
the same without ``log_w`` for ``GPKroneckerRegression`` and
``GPSKIRegression``; ``kernel.log_lengthscale`` or
``kernel.0.log_lengthscale``, …, ``log_noise`` for ``GPRegression``, whose
kernel may also be an ``extra`` kernel: ``kernel.k1.k2.log_period``); the port's
``state_dict()`` uses the same names.  These helpers take plain NumPy arrays,
so this module needs no JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from gp_grief_tpu_torch.kernels.grief import GriefBasis

__all__ = ["params_from_jax", "basis_from_jax"]

_LEAF = re.compile(
    r"^((kernels\.\d+|kernel(\.\d+)?)(\.k[12])*\.(log_lengthscale|log_variances?|log_alpha|log_period)"
    r"|log_noise|log_w)$"
)


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port from the JAX leaves keyed by dotted name
    (``dict(zip(model._param_leaf_names(), leaves))`` on the JAX side);
    ``load_state_dict`` casts it to the model's dtype and device.  Takes the
    leaves of ``GPGriefModel``, ``GPRegression``, ``GPKroneckerRegression``
    and ``GPSKIRegression``; raises on any other name."""
    out = {}
    for name, value in flat.items():
        if not _LEAF.match(name):
            raise KeyError(f"params_from_jax: {name!r} is not a parameter leaf of a ported model")
        out[name] = torch.as_tensor(np.array(value))
    return out


def basis_from_jax(
    Qs: Sequence[np.ndarray],
    lams: Sequence[np.ndarray],
    log_lam: np.ndarray,
    idx: np.ndarray,
) -> GriefBasis:
    """The port's :class:`GriefBasis` (on the CPU) from a JAX ``GriefBasis``'s
    arrays, eigenvectors with the JAX signs, so Φ compares elementwise."""

    def t(a):
        return torch.as_tensor(np.array(a))

    return GriefBasis(
        Qs=tuple(t(q) for q in Qs),
        lams=tuple(t(lam) for lam in lams),
        log_lam=t(log_lam),
        idx=t(idx).to(torch.int64),
    )
