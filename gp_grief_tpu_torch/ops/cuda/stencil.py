"""Kernel K5: the SKI ``WᵀW`` stencil apply on the card.

Counterpart of ``gp_grief_tpu.ops.interp_stencil._apply_pallas``; the CUDA
source is ``csrc/wtw_stencil.cu``.  :func:`wtw_stencil` checks its operands
and then

* on CPU tensors runs the plain version
  :func:`~gp_grief_tpu_torch.ops.interp_stencil.stencil_apply_ref`;
* on CUDA tensors launches the kernel on the current stream, or raises.  It
  never falls back to the plain version on the card.

``wtw_stencil.launches`` counts kernel launches and nothing else.  ``WᵀW`` is
symmetric, so the backward pass is the same stencil on the cotangent, as in
the JAX package's custom VJP.
"""

from __future__ import annotations

import torch

from gp_grief_tpu_torch.ops.cuda import _build
from gp_grief_tpu_torch.ops.interp_stencil import WtWStencil, stencil_apply_ref

__all__ = ["wtw_stencil"]

_SYMBOLS = {torch.float32: "gp_grief_wtw_stencil_f32", torch.float64: "gp_grief_wtw_stencil_f64"}


def _launch(st: WtWStencil, v: torch.Tensor) -> torch.Tensor:
    if v.dtype not in _SYMBOLS:
        raise TypeError(f"wtw_stencil kernel takes float32 or float64, got {v.dtype}")
    if st.tables.dtype != v.dtype:
        raise TypeError(f"wtw_stencil: tables are {st.tables.dtype}, v is {v.dtype}")
    if not (v.is_contiguous() and st.tables.is_contiguous()):
        raise ValueError("wtw_stencil kernel needs contiguous v and tables")
    B, M = int(v.shape[0]), st.M
    out = torch.empty((B, M), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    # The library is loaded once (ctypes keeps each symbol after its first
    # lookup); the device's raw stream handle, with no device context or
    # Stream object per call.
    fn = getattr(_build.load_library(), _SYMBOLS[v.dtype])
    device = v.device.index
    err = fn(v.data_ptr(), st.tables.data_ptr(), st.delta_t.data_ptr(), len(st.deltas), out.data_ptr(), B, M,
             device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"wtw_stencil kernel launch failed with cudaError {err} at (B, M, D) = "
                           f"{(B, M, len(st.deltas))}")
    wtw_stencil.launches += 1
    return out


def _apply(st: WtWStencil, v: torch.Tensor) -> torch.Tensor:
    if v.device.type == "cuda":
        return _launch(st, v)
    if v.device.type == "cpu":
        return stencil_apply_ref(st, v)
    raise ValueError(f"wtw_stencil: no kernel for device {v.device}")


class _WtW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, st, v):
        ctx.st = st
        return _apply(st, v)

    @staticmethod
    def backward(ctx, g):
        return None, _apply(ctx.st, g.contiguous())


def wtw_stencil(st: WtWStencil, v_bm: torch.Tensor) -> torch.Tensor:
    """``WᵀW v`` for batch-major lattice vectors ``v_bm`` ``(B, M)``.
    Differentiable in ``v_bm``."""
    if v_bm.ndim != 2 or int(v_bm.shape[1]) != st.M:
        raise ValueError(f"wtw_stencil: v must be (B, {st.M}), got {tuple(v_bm.shape)}")
    if st.tables.device != v_bm.device:
        raise ValueError(f"wtw_stencil: tables on {st.tables.device}, v on {v_bm.device}")
    if torch.is_grad_enabled() and v_bm.requires_grad:
        return _WtW.apply(st, v_bm)
    return _apply(st, v_bm)  # a solver's apply: no graph to build


wtw_stencil.launches = 0
