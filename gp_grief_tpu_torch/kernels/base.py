"""Positivity transforms for the log-space hyperparameters.

Counterpart of ``gp_grief_tpu.kernels.base``.  Every hyperparameter is stored
unconstrained (``log`` of the positive value), so flat parameter vectors line
up between the two packages.
"""

from __future__ import annotations

import torch

__all__ = ["positive", "inverse_positive"]


def positive(raw: torch.Tensor) -> torch.Tensor:
    """Unconstrained → positive: ``exp``."""
    return torch.exp(raw)


def inverse_positive(value, *, dtype: torch.dtype = torch.float64, device=None) -> torch.Tensor:
    """Positive → unconstrained.  The log is taken in float64 and then cast to
    ``dtype``, as the JAX package does under x64."""
    v = torch.as_tensor(value, dtype=torch.float64)
    return torch.log(v).to(dtype=dtype, device=device)
