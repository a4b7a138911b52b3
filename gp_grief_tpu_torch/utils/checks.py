"""Runtime finiteness guards that raise naming the site.

Counterpart of ``gp_grief_tpu.utils.checks``: where the JAX package wraps a
function with ``checkify`` so a non-finite intermediate raises with a named
site, the port checks eagerly.  :func:`check_finite` raises at once (one
host read of the tensor's flag); :func:`guarded` adds the check to every
floating output of a function.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["check_finite", "guarded"]


def check_finite(x, name: str = "value") -> None:
    """Raise ``FloatingPointError`` if ``x`` holds a NaN or an infinity."""
    finite = bool(torch.isfinite(x).all()) if isinstance(x, torch.Tensor) else bool(np.all(np.isfinite(x)))
    if not finite:
        raise FloatingPointError(f"non-finite values in {name}")


def _floating_leaves(out: Any):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, (np.ndarray, np.floating)):
        if np.issubdtype(out.dtype, np.floating):
            yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _floating_leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _floating_leaves(v)


def guarded(fn: Callable, *, check_output: bool = True) -> Callable:
    """``fn`` whose floating tensor and array outputs (nested in tuples,
    lists and dicts) are checked with :func:`check_finite`; checks inside
    ``fn`` raise as they run."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if check_output:
            for leaf in _floating_leaves(out):
                check_finite(leaf, "output")
        return out

    return wrapped
