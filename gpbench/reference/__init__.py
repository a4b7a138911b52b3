"""The plain reference that decides ``correct``.

Plain PyTorch, written from the models' mathematics and nothing of the
program: it imports neither JAX nor ``gp_grief_tpu`` nor
``gp_grief_tpu_torch``, and takes nothing the program made.  It is handed
the benchmark's own inputs (data, grid, parameters, seeds) and works out
again whatever the program derives from them (interpolation weights,
Kronecker factors and eigenbases, the probes' draw, solves).  It runs in
float64; the control is the same code in float32 with TF32 matrix products
(``Precision.control``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Precision", "round_tf32", "rademacher", "seeded_generator", "step_seed", "adam_steps"]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest: the
    operand a TF32 tensor core multiplies.  Under autograd the rounding
    passes the gradient through unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach() if t.requires_grad else r


@dataclass(frozen=True)
class Precision:
    """The reference's arithmetic: its dtype, whether matrix products run in
    TF32, and the relative tolerance of its own CG solves."""

    dtype: torch.dtype
    tf32: bool
    cg_tol: float

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b``; in TF32 the operands are rounded to TF32 first and the
        products summed in float32, as a TF32 tensor core does (cuBLAS may
        keep small products off the tensor cores even where TF32 is allowed,
        so the rounding is made here)."""
        if self.tf32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)

    @staticmethod
    def exact() -> "Precision":
        return Precision(torch.float64, False, 1e-11)

    @staticmethod
    def control(cg_tol: float) -> "Precision":
        """One grade below the configurations' float32 with TF32 off:
        float32 storage, TF32 matrix products, the configuration's CG
        tolerance."""
        return Precision(torch.float32, True, cg_tol)


def seeded_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def step_seed(seed: int, step: int) -> int:
    """The seed of training step ``step``'s probes for a model seeded with
    ``seed`` (the SKI model's documented ``(seed, 1000 + step)`` draw)."""
    return int(np.random.SeedSequence([int(seed), 1000 + int(step)]).generate_state(1)[0])


def rademacher(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """±1 probes: a fair bit per entry from ``torch.randint`` on the
    generator's device (the models' documented draw)."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def adam_steps(theta: dict, grad_fn, steps: int, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
    """``steps`` Adam updates (Kingma & Ba, with bias correction) of the
    leaves ``theta`` (name → float64 tensor); ``grad_fn(theta, step) ->
    (loss, grads)``.  Returns ``(losses, first_grads, theta_after)``."""
    b1, b2 = betas
    m = {k: torch.zeros_like(v) for k, v in theta.items()}
    v2 = {k: torch.zeros_like(v) for k, v in theta.items()}
    theta = {k: v.clone() for k, v in theta.items()}
    losses, first = [], None
    for t in range(1, steps + 1):
        loss, g = grad_fn(theta, t - 1)
        losses.append(float(loss))
        if first is None:
            first = {k: g[k].clone() for k in g}
        for k in theta:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            mh = m[k] / (1 - b1**t)
            vh = v2[k] / (1 - b2**t)
            theta[k] = theta[k] - lr * mh / (torch.sqrt(vh) + eps)
    return losses, first, theta
