"""Hyperparameter optimization: autograd NLML + ``torch.optim`` Adam / L-BFGS.

Counterpart of ``gp_grief_tpu.optimize``.  ``fit`` is a plain per-step loop:
the JAX package's ``scan_chunk`` device loop (several steps per compiled
program) has no counterpart, because PyTorch dispatches each step eagerly.

* Adam is ``torch.optim.Adam`` with ε = 1e-8 added outside the square root,
  the same update as ``optax.adam``, so the two agree step by step.
* L-BFGS is ``torch.optim.LBFGS`` with a strong-Wolfe line search, one
  iteration per step.  Its line search differs from optax's, so the two agree
  on the converged objective, not step by step.

A step whose loss is non-finite is rejected: the parameters and the optimizer
state stay at the last good step and the loop stops.  ``checkgrad`` compares
autograd against Richardson-extrapolated central finite differences.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["fit", "FitResult", "checkgrad"]

NamedParams = Sequence[Tuple[str, torch.nn.Parameter]]


class FitResult(NamedTuple):
    """Trace of a :func:`fit` run.  Unlike the JAX package's result it holds
    no ``params``: ``fit`` updates the parameters in place."""

    losses: np.ndarray  # (iters,) objective trace, at each step's starting point
    grad_norms: np.ndarray  # (iters,) global L2 gradient norm there
    iterations: int
    wall_time: float
    converged: bool
    # Optimizer ``state_dict()``: pass back as ``fit(opt_state=...)`` to
    # resume (fit(n) then fit(m, opt_state=...) reproduces fit(n+m) for Adam).
    opt_state: Any = None


def _grad_norm(params) -> float:
    sq = [p.grad.double().pow(2).sum() for p in params if p.grad is not None]
    return float(torch.sqrt(torch.stack(sq).sum())) if sq else 0.0


def fit(
    loss_fn: Callable[[], torch.Tensor],
    named_params: NamedParams,
    *,
    optimizer: str = "lbfgs",
    max_iters: int = 100,
    tol: float = 1e-6,
    learning_rate: float = 0.05,
    verbose: bool = False,
    callback: Optional[Callable[[int, float, float], None]] = None,
    fixed: Optional[Mapping[str, bool]] = None,
    opt_state: Any = None,
) -> FitResult:
    """Minimize ``loss_fn()`` over ``named_params`` in place.

    ``loss_fn`` reads the parameters itself (a closure over the model).
    ``fixed`` maps parameter names to ``True`` for the ones held constant:
    their gradient is zeroed, so neither optimizer moves them.  Convergence:
    global gradient norm below ``tol``.
    """
    params = [p for _, p in named_params]
    frozen = [p for n, p in named_params if fixed and fixed.get(n, False)]
    if optimizer == "lbfgs":
        # One L-BFGS iteration per step; up to 25 evaluations in its search.
        opt = torch.optim.LBFGS(params, lr=1.0, max_iter=1, max_eval=25, line_search_fn="strong_wolfe")
    elif optimizer == "adam":
        opt = torch.optim.Adam(params, lr=learning_rate, eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if opt_state is not None:
        opt.load_state_dict(opt_state)

    start: Dict[str, float] = {}  # loss and gradient norm at the step's starting point

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        for p in frozen:
            if p.grad is not None:
                p.grad.zero_()
        if not start:
            start["loss"], start["gnorm"] = float(loss.detach()), _grad_norm(params)
        return loss

    losses, gnorms = [], []
    t0 = time.perf_counter()
    converged = False
    it = 0
    while it < max_iters and not converged:
        it += 1
        start.clear()
        if optimizer == "adam":
            closure()
            if not np.isfinite(start["loss"]):
                break  # rejected before stepping: params and moments untouched
            opt.step()
        else:
            saved = ([p.detach().clone() for p in params], copy.deepcopy(opt.state_dict()))
            opt.step(closure)
            if not np.isfinite(start["loss"]):
                with torch.no_grad():
                    for p, v in zip(params, saved[0]):
                        p.copy_(v)
                opt.load_state_dict(saved[1])
                break
        value, gnorm = start["loss"], start["gnorm"]
        losses.append(value)
        gnorms.append(gnorm)
        if verbose:
            print(f"[fit:{optimizer}] iter {it:4d}  loss {value:.6f}  |g| {gnorm:.3e}")
        if callback is not None:
            callback(it, value, gnorm)
        if gnorm < tol:
            converged = True
    return FitResult(
        losses=np.asarray(losses),
        grad_norms=np.asarray(gnorms),
        iterations=len(losses),
        wall_time=time.perf_counter() - t0,
        converged=converged,
        opt_state=opt.state_dict(),
    )


def _checkgrad_indices(sizes: Sequence[int], sample: Optional[int], seed: int):
    """Flat indices to probe: all, or (small leaves ∪ a seeded random subset
    of large-leaf components) when ``sample`` caps the count."""
    total = int(sum(sizes))
    if sample is None or sample >= total:
        return range(total)
    small, large = [], []
    off = 0
    for ln in sizes:
        (small if ln <= 4 else large).extend(range(off, off + ln))
        off += ln
    take = max(0, min(sample - len(small), len(large)))
    rng = np.random.default_rng(seed)
    picked = rng.choice(len(large), size=take, replace=False) if take else []
    return sorted(set(small) | {large[int(j)] for j in picked})


def checkgrad(
    loss_fn: Callable[[], torch.Tensor],
    params: Sequence[torch.Tensor],
    *,
    eps: float = 1e-6,
    rtol: float = 1e-4,
    verbose: bool = False,
    sample: Optional[int] = None,
    sample_seed: int = 0,
):
    """Compare autograd against central finite differences per component.

    Same probe as ``gp_grief_tpu.optimize.checkgrad``: a Richardson-
    extrapolated central difference ``(4·fd(h) − fd(2h))/3`` with the step
    scaled by ``∛|f|`` and a per-component round-off floor.  The parameters
    are perturbed in place and restored.  Returns ``(ok, rows)`` with rows
    ``(index, analytic, numerical, relative_error)``.
    """
    params = list(params)
    sizes = [p.numel() for p in params]
    flat0 = torch.cat([p.detach().reshape(-1) for p in params]).double().cpu().numpy()

    def set_flat(vec):
        off = 0
        with torch.no_grad():
            for p, n in zip(params, sizes):
                p.copy_(torch.as_tensor(vec[off : off + n]).reshape(p.shape))
                off += n

    def f(vec) -> float:
        set_flat(vec)
        with torch.no_grad():
            return float(loss_fn())

    try:
        for p in params:
            p.grad = None
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        analytic = torch.cat(
            [(g if g is not None else torch.zeros_like(p)).reshape(-1) for g, p in zip(grads, params)]
        ).double().cpu().numpy()
        f0 = abs(float(loss.detach()))
        eps_f = float(torch.finfo(params[0].dtype).eps)
        step_scale = min(max(1.0, f0 ** (1.0 / 3.0)), 1e4)
        rows = []
        ok = True
        for i in _checkgrad_indices(sizes, sample, sample_seed):
            e = np.zeros_like(flat0)
            h = eps * step_scale * max(1.0, abs(flat0[i]))
            e[i] = h
            fd_h = (f(flat0 + e) - f(flat0 - e)) / (2 * h)
            fd_2h = (f(flat0 + 2 * e) - f(flat0 - 2 * e)) / (4 * h)
            num = (4.0 * fd_h - fd_2h) / 3.0
            denom = max(abs(analytic[i]), abs(num), 1e-12)
            rel = abs(analytic[i] - num) / denom
            noise_floor_i = 8.0 * 64.0 * eps_f * (1.0 + f0) / h
            bad = rel > rtol and abs(analytic[i] - num) > noise_floor_i
            rows.append((i, analytic[i], num, rel))
            ok = ok and not bad
            if verbose:
                flag = "  <-- MISMATCH" if bad else ""
                print(f"  param[{i:3d}]  analytic {analytic[i]:+.6e}  fd {num:+.6e}  rel {rel:.2e}{flag}")
    finally:
        set_flat(flat0)
    return ok, rows
