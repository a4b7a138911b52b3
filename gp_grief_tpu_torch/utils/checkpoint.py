"""Checkpoint and resume: parameter trees (and optimizer state) as ``.npz``.

Counterpart of ``gp_grief_tpu.utils.checkpoint``, with the same layout: one
array per leaf, keyed by its tree path joined with ``/`` (dict keys, list
and tuple indices, named-tuple fields).  A model's parameters are its
``state_dict()``, whose dotted names (``kernels.0.log_lengthscale``) become
the JAX package's paths (``kernels/0/log_lengthscale``), so a checkpoint
written by either package loads in the other.  A tree may hold
``nn.Module``\\ s (saved as their ``state_dict()``), tensors, NumPy arrays,
Python scalars and strings, and ``None`` (no leaf): the optimizer
``state_dict`` that ``fit`` returns as ``opt_state`` round-trips with it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["save_pytree", "load_pytree"]


def _flatten(tree, path: Tuple[str, ...], out: dict) -> None:
    if tree is None:
        return
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict().items():
            _flatten(t, path + tuple(name.split(".")), out)
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, path + (str(i),), out)
    else:
        out["/".join(path)] = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def save_pytree(path: str, tree: Any) -> None:
    """Write every leaf of ``tree`` to ``path`` (.npz), keyed by tree path."""
    flat: dict = {}
    _flatten(tree, (), flat)
    np.savez(path, **flat)


def _restore(like, path: Tuple[str, ...], data, src: str):
    if like is None:
        return None
    if isinstance(like, nn.Module):
        return OrderedDict((name, _restore(t, path + tuple(name.split(".")), data, src))
                           for name, t in like.state_dict().items())
    if isinstance(like, Mapping):
        return type(like)((k, _restore(v, path + (str(k),), data, src)) for k, v in like.items())
    if isinstance(like, (list, tuple)):
        return type(like)(_restore(v, path + (str(i),), data, src) for i, v in enumerate(like))
    key = "/".join(path)
    if key not in data:
        raise KeyError(f"checkpoint {src!r} missing leaf {key!r}")
    arr = data[key]
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(dtype=like.dtype, device=like.device)
    if isinstance(like, np.ndarray):
        return np.asarray(arr, dtype=like.dtype)
    if isinstance(like, (bool, int, float, str)):
        return type(like)(arr.item())
    return arr


def load_pytree(path: str, like: Any) -> Any:
    """Restore a tree with the structure, dtypes and devices of ``like``.  An
    ``nn.Module`` in ``like`` comes back as a ``state_dict`` for its
    ``load_state_dict``."""
    with np.load(path) as data:
        return _restore(like, (), data, path)
