"""Model base: parameter plumbing and the weighted-basis NLML shared by models.

Counterpart of ``gp_grief_tpu.models.base``.  A model is an ``nn.Module``
whose parameters carry the JAX package's dotted leaf names
(``kernels.0.log_lengthscale``, …, ``log_noise``, ``log_w``), and the flat
``parameters`` vector lists them in the order ``ravel_pytree`` flattens the
JAX parameter dict (sorted keys), so ``state_dict()`` keys and flat vectors
line up between the two packages.

Weighted-basis math (matrix inversion and determinant lemmas), with
``Φ (n×p)``, ``W = diag(w)``, ``K̃ = Φ W Φᵀ + σ² I``:

    P            = ΦᵀΦ + σ² W⁻¹                                (p×p)
    yᵀ K̃⁻¹ y     = (yᵀy − vᵀ P⁻¹ v) / σ²,        v = Φᵀ y
    log|K̃|       = log|P| + Σ log w + (n−p) log σ²
    θ | y        ~ N(P⁻¹ v, σ² P⁻¹)              (weight-space posterior)

so each NLML evaluation is O(p³) after O(n·p²) one-time reductions.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from gp_grief_tpu_torch.optimize import FitResult, checkgrad, fit
from gp_grief_tpu_torch.ops.solve import cholesky, logdet_from_chol, solve_chol

__all__ = [
    "BaseModel", "BasisStats", "basis_nlml", "basis_posterior", "basis_stats_from_phi", "check_xy",
    "resolve_device",
]


def resolve_device(x, device) -> torch.device:
    """The device a model lives on: ``device`` when given, else the device of
    a tensor ``x``, else the card.  ``device="cpu"`` is the only way onto the
    CPU; with no CUDA device and no explicit device this raises rather than
    running quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: models run on the card by default; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def check_xy(x: torch.Tensor, y: torch.Tensor, what: str = "x"):
    """Shape-validate a training pair: ``x (n, d)`` (1-D promoted) against
    ``y`` with exactly ``n`` responses; raises ``ValueError`` otherwise."""
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"{what} must be (n, d); got shape {tuple(x.shape)}")
    if y.ndim != 1 and y.numel() == x.shape[0]:
        y = y.reshape(-1)
    if y.ndim != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(
            f"y must have one response per row of {what}: "
            f"{what} has {x.shape[0]} rows, y has shape {tuple(y.shape)}"
        )
    return x, y


def _matches(name: str, pattern: str) -> bool:
    return name == pattern or name.endswith("." + pattern)


def _jax_order(name: str, root: nn.Module):
    """Sort key reproducing ``ravel_pytree``'s leaf order: dict keys sorted,
    list indices numeric (``kernels.2`` before ``kernels.10``), a kernel
    dataclass's fields in declaration order (the module's ``jax_fields``)."""
    key, mod = [], root
    for s in name.split("."):
        fields = getattr(mod, "jax_fields", ())
        if s.isdigit():
            key.append((0, int(s), ""))
        else:
            key.append((1, fields.index(s) if s in fields else 0, s))
        mod = getattr(mod, s, None)
    return tuple(key)


class BaseModel(nn.Module):
    """Stateful model API around an NLML closure.

    Subclasses register their parameters and implement ``_loss()``, the
    negative log marginal likelihood at the current parameters.

    ``parameters`` is the JAX package's flat parameter vector (a property
    with a setter), so it shadows ``nn.Module.parameters()``; iterate
    ``named_parameters()`` for the tensors.
    """

    def _loss(self) -> torch.Tensor:
        raise NotImplementedError

    # -- flat parameter vector (JAX order) ---------------------------------

    def _leaves(self):
        """``(name, parameter)`` pairs in the JAX package's flat order."""
        return sorted(self.named_parameters(), key=lambda kv: _jax_order(kv[0], self))

    @property
    def parameters(self) -> np.ndarray:
        """Flat (log-transformed) hyperparameter vector, in the order of the
        JAX package's ``ravel_pytree``."""
        return torch.cat([p.detach().reshape(-1) for _, p in self._leaves()]).cpu().numpy()

    @parameters.setter
    def parameters(self, vec) -> None:
        vec = np.array(vec)
        leaves = self._leaves()
        total = sum(p.numel() for _, p in leaves)
        if vec.shape != (total,):
            raise ValueError(f"expected {total} parameters, got {vec.shape}")
        off = 0
        with torch.no_grad():
            for _, p in leaves:
                p.copy_(torch.as_tensor(vec[off : off + p.numel()]).reshape(p.shape))
                off += p.numel()

    # nn.Module's own versions call self.parameters(), which the property shadows.
    def zero_grad(self, set_to_none: bool = True) -> None:
        for _, p in self.named_parameters():
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()

    def requires_grad_(self, requires_grad: bool = True):
        for _, p in self.named_parameters():
            p.requires_grad_(requires_grad)
        return self

    # -- fix / free -----------------------------------------------------------

    def _param_leaf_names(self):
        """Dotted name per parameter, e.g. ``kernels.0.log_lengthscale``."""
        return [n for n, _ in self._leaves()]

    def fix(self, *patterns: str) -> None:
        """Hold parameters fixed during ``optimize`` (zero gradient).

        A pattern matches a name it equals or a dot-separated suffix of it
        (``"log_lengthscale"`` fixes every dimension's lengthscale).  Raises
        on a pattern that matches nothing.
        """
        names = self._param_leaf_names()
        for pat in patterns:
            if not any(_matches(n, pat) for n in names):
                raise ValueError(f"fix: pattern {pat!r} matches no parameter in {names}")
        self._fixed_patterns = getattr(self, "_fixed_patterns", set()) | set(patterns)

    def free(self, *patterns: str) -> None:
        """Undo :meth:`fix` for the given patterns (all, if none given)."""
        cur = getattr(self, "_fixed_patterns", set())
        self._fixed_patterns = cur - set(patterns) if patterns else set()

    @property
    def fixed_parameters(self) -> list:
        """Dotted names of the currently fixed parameters."""
        pats = getattr(self, "_fixed_patterns", set())
        return [n for n in self._param_leaf_names() if any(_matches(n, p) for p in pats)]

    def _fixed_mask(self) -> Optional[Dict[str, bool]]:
        fixed = self.fixed_parameters
        return {n: True for n in fixed} if fixed else None

    # -- objective --------------------------------------------------------------

    def log_likelihood(self) -> float:
        """Log marginal likelihood at the current parameters."""
        with torch.no_grad():
            return -float(self._loss())

    def optimize(self, **kwargs) -> FitResult:
        """Maximize the log marginal likelihood (see :func:`fit`)."""
        kwargs.setdefault("fixed", self._fixed_mask())
        return fit(self._loss, self._leaves(), **kwargs)

    def checkgrad(
        self,
        *,
        eps: float = 1e-6,
        rtol: float = 1e-4,
        verbose: bool = False,
        sample: int | None = None,
        sample_seed: int = 0,
    ) -> bool:
        """Validate autograd against central finite differences."""
        ok, _ = checkgrad(
            self._loss, [p for _, p in self._leaves()], eps=eps, rtol=rtol,
            verbose=verbose, sample=sample, sample_seed=sample_seed,
        )
        return ok


class BasisStats(NamedTuple):
    """Sufficient statistics of a fixed basis: one-time O(n·p²) reductions."""

    C: torch.Tensor  # (p, p) ΦᵀΦ
    v: torch.Tensor  # (p,)   Φᵀy
    yy: torch.Tensor  # ()     yᵀy
    n: int


def basis_stats_from_phi(Phi: torch.Tensor, y: torch.Tensor, *, chunk: int = 131072) -> BasisStats:
    """``BasisStats`` of a dense precomputed ``Φ``, accumulated over row
    blocks of ``chunk`` rows."""
    n = Phi.shape[0]
    C = v = yy = 0.0
    for s in range(0, n, chunk):
        Pk, yk = Phi[s : s + chunk], y[s : s + chunk]
        C = C + Pk.T @ Pk
        v = v + Pk.T @ yk
        yy = yy + torch.dot(yk, yk)
    return BasisStats(C=C, v=v, yy=yy, n=n)


def _posterior_precision(stats: BasisStats, log_w, log_noise) -> torch.Tensor:
    sigma2 = torch.exp(log_noise)
    return stats.C + torch.diag(sigma2 * torch.exp(-log_w))


def basis_nlml(stats: BasisStats, log_w: torch.Tensor, log_noise: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood of the weighted-basis GP, O(p³)."""
    p = stats.C.shape[0]
    sigma2 = torch.exp(log_noise)
    L = cholesky(_posterior_precision(stats, log_w, log_noise))
    Linv_v = torch.linalg.solve_triangular(L, stats.v[:, None], upper=False)[:, 0]
    quad = (stats.yy - torch.sum(Linv_v**2)) / sigma2
    logdet = logdet_from_chol(L) + torch.sum(log_w) + (stats.n - p) * log_noise
    return 0.5 * (quad + logdet + stats.n * math.log(2.0 * math.pi))


def basis_posterior(stats: BasisStats, log_w: torch.Tensor, log_noise: torch.Tensor):
    """Weight-space posterior ``(L_P, θ_mean)`` with ``cov = σ² P⁻¹``."""
    L = cholesky(_posterior_precision(stats, log_w, log_noise))
    return L, solve_chol(L, stats.v)
