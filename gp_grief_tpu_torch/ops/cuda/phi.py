"""Kernel K1: the fused GRIEF Φ assembly, ``Φ = Π_d (B_d @ S_d)``.

Counterpart of ``gp_grief_tpu.ops.pallas.phi_pallas.phi_fused_pallas``; the
CUDA source is ``csrc/phi_fused.cu``.  :func:`phi_fused` checks its operands
and then

* on CPU tensors runs the plain version :func:`phi_fused_ref` (the
  counterpart of ``phi_pallas._phi_xla_ref``);
* on CUDA tensors launches the kernel on the current stream, or raises.  It
  never falls back to the plain version on the card.

``phi_fused.launches`` counts kernel launches and nothing else.  The backward
pass is the plain version's vector-Jacobian product, as in the JAX package's
custom VJP: the TPU kernel had no backward kernel either.
"""

from __future__ import annotations

import torch

__all__ = ["phi_fused", "phi_fused_ref"]

_SYMBOLS = {torch.float32: "gp_grief_phi_fused_f32", torch.float64: "gp_grief_phi_fused_f64"}
_INT_MAX = 2**31 - 1


def phi_fused_ref(B_stack: torch.Tensor, S_stack: torch.Tensor) -> torch.Tensor:
    """Plain version: d batched ``(n, m)·(m, p)`` products, then their
    elementwise product over d."""
    return torch.einsum("dnm,dmp->dnp", B_stack, S_stack).prod(0)


def _check_operands(B: torch.Tensor, S: torch.Tensor) -> None:
    if B.ndim != 3 or S.ndim != 3:
        raise ValueError(f"phi_fused needs B (d, n, m) and S (d, m, p); got {tuple(B.shape)}, {tuple(S.shape)}")
    d, n, m = B.shape
    if d < 1 or S.shape[0] != d or S.shape[1] != m:
        raise ValueError(f"phi_fused: B {tuple(B.shape)} and S {tuple(S.shape)} do not match (d, n, m) x (d, m, p)")
    if B.device != S.device:
        raise ValueError(f"phi_fused: operands on {B.device} and {S.device}")
    if B.dtype != S.dtype:
        raise TypeError(f"phi_fused: operand dtypes differ ({B.dtype}, {S.dtype})")


def _launch(B: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    if B.dtype not in _SYMBOLS:
        raise TypeError(f"phi_fused kernel takes float32 or float64, got {B.dtype}")
    if not (B.is_contiguous() and S.is_contiguous()):
        raise ValueError("phi_fused kernel needs contiguous B and S")
    d, n, m = B.shape
    p = S.shape[2]
    if max(d, n, m, p) > _INT_MAX:
        raise ValueError(f"phi_fused kernel: extents {(d, n, m, p)} exceed int32")
    out = torch.empty((n, p), dtype=B.dtype, device=B.device)
    if out.numel() == 0:
        return out
    from gp_grief_tpu_torch.ops.cuda._build import load_library

    fn = getattr(load_library(), _SYMBOLS[B.dtype])
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(B.data_ptr(), S.data_ptr(), out.data_ptr(), d, n, m, p, stream)
    if err != 0:
        raise RuntimeError(f"phi_fused kernel launch failed with cudaError {err} at (d, n, m, p) = {(d, n, m, p)}")
    phi_fused.launches += 1
    return out


class _PhiFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, B, S):
        ctx.save_for_backward(B, S)
        if B.device.type == "cuda":
            return _launch(B, S)
        if B.device.type == "cpu":
            return phi_fused_ref(B, S)
        raise ValueError(f"phi_fused: no kernel for device {B.device}")

    @staticmethod
    def backward(ctx, g):
        B, S = ctx.saved_tensors
        with torch.enable_grad():
            b = B.detach().requires_grad_()
            s = S.detach().requires_grad_()
            out = phi_fused_ref(b, s)
        return torch.autograd.grad(out, (b, s), g)


def phi_fused(B_stack: torch.Tensor, S_stack: torch.Tensor) -> torch.Tensor:
    """Fused ``Φ[i, j] = Π_d (B_stack[d] @ S_stack[d])[i, j]``.

    ``B_stack``: ``(d, n, m)``, ``S_stack``: ``(d, m, p)``; returns ``(n, p)``.
    Differentiable in both operands.
    """
    _check_operands(B_stack, S_stack)
    return _PhiFused.apply(B_stack, S_stack)


phi_fused.launches = 0
