"""Kernel K4: the SKI interpolation transpose ``Wᵀ u`` on the card.

Counterpart of ``gp_grief_tpu.ops.interp.make_onehot_rmatvec`` (the one-hot
Pallas kernel); the CUDA source is ``csrc/interp_wt.cu``, a deterministic
segmented sum over the cell-sorted stream of an
:class:`~gp_grief_tpu_torch.ops.interp.InterpPlan`.  :func:`interp_wt` checks
its operands and then

* on CPU tensors runs the plain version
  :func:`~gp_grief_tpu_torch.ops.interp.interp_rmatvec_bm_exact`;
* on CUDA tensors launches the kernel on the current stream, or raises.  It
  never falls back to the plain version on the card.

``interp_wt.launches`` counts kernel launches and nothing else.  The backward
pass is ``W`` applied to the cotangent (the fused gather
:func:`~gp_grief_tpu_torch.ops.interp.interp_matvec_bm_fast`), as in the JAX
package's custom VJP.

:func:`interp_w` is the forward gather ``W v`` with K4 as its backward: the
adjoint of ``W`` is ``Wᵀ``, so its gradient is the same deterministic
segmented sum, where autograd's own rule for the gather would scatter with
atomic adds.  Its launches count in ``interp_wt.launches`` too.
"""

from __future__ import annotations

import torch

from gp_grief_tpu_torch.ops.cuda import _build
from gp_grief_tpu_torch.ops.interp import InterpPlan, interp_matvec_bm_fast, interp_rmatvec_bm_exact
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["interp_w", "interp_wt"]

_SYMBOLS = {torch.float32: "gp_grief_interp_wt_f32", torch.float64: "gp_grief_interp_wt_f64"}
_interp_span = _prof.site("gp_grief.interp", "op", "B", "length")


def u_layout(u: torch.Tensor) -> torch.Tensor:
    """The operand K4 reads for batch-major ``u`` ``(B, n)``: ``u``
    point-major, element ``(b, p)`` at ``p * B + b``, so that the rows one
    stream entry gathers are adjacent.  A copy (one more launch) at ``B > 1``;
    at ``B = 1`` ``u`` itself."""
    return u.T.contiguous()


def _launch(plan: InterpPlan, u: torch.Tensor) -> torch.Tensor:
    if u.dtype not in _SYMBOLS:
        raise TypeError(f"interp_wt kernel takes float32 or float64, got {u.dtype}")
    if plan.w_sorted.dtype != u.dtype:
        raise TypeError(f"interp_wt: plan weights are {plan.w_sorted.dtype}, u is {u.dtype}")
    B, n = int(u.shape[0]), int(u.shape[1])
    M = plan.M
    out = torch.empty((B, M), dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    # The library is loaded once (ctypes keeps each symbol after its first
    # lookup); the device's raw stream handle, with no device context or
    # Stream object per call.
    fn = getattr(_build.load_library(), _SYMBOLS[u.dtype])
    ua = u_layout(u)
    device = u.device.index
    err = fn(ua.data_ptr(), plan.src_col.data_ptr(), plan.w_sorted.data_ptr(), plan.start_ptr.data_ptr(),
             plan.end_ptr.data_ptr(), out.data_ptr(), B, M, plan.src_col.shape[0], device,
             torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"interp_wt kernel launch failed with cudaError {err} at (B, n, M) = {(B, n, M)}")
    interp_wt.launches += 1
    return out


def _forward(plan: InterpPlan, u: torch.Tensor) -> torch.Tensor:
    if u.device.type == "cuda":
        return _launch(plan, u)
    if u.device.type == "cpu":
        return interp_rmatvec_bm_exact(plan, u)
    raise ValueError(f"interp_wt: no kernel for device {u.device}")


class _InterpWt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, u):
        ctx.plan = plan
        return _forward(plan, u)

    @staticmethod
    def backward(ctx, g):
        return None, interp_matvec_bm_fast(ctx.plan, g)


def interp_wt(plan: InterpPlan, u_bm: torch.Tensor) -> torch.Tensor:
    """``Wᵀ u`` for batch-major ``u_bm`` ``(B, n)`` → ``(B, M)``, ``W`` the
    interpolation matrix of ``plan``.  Differentiable in ``u_bm``."""
    if u_bm.ndim != 2 or int(u_bm.shape[1]) != plan.n:
        raise ValueError(f"interp_wt: u must be (B, {plan.n}), got {tuple(u_bm.shape)}")
    if plan.src_col.device != u_bm.device:
        raise ValueError(f"interp_wt: plan on {plan.src_col.device}, u on {u_bm.device}")
    with _interp_span("wt", int(u_bm.shape[0]), int(u_bm.shape[1])):
        if torch.is_grad_enabled() and u_bm.requires_grad:
            return _InterpWt.apply(plan, u_bm)
        return _forward(plan, u_bm)  # a solver's apply: no graph to build


interp_wt.launches = 0


class _InterpW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, v):
        ctx.plan = plan
        return interp_matvec_bm_fast(plan, v)

    @staticmethod
    def backward(ctx, g):
        return None, _forward(ctx.plan, g.contiguous())


def interp_w(plan: InterpPlan, v_bm: torch.Tensor) -> torch.Tensor:
    """``W v`` for batch-major lattice vectors ``v_bm`` ``(B, M)`` → ``(B, n)``
    (one fused gather).  Differentiable in ``v_bm``, with ``Wᵀ`` (K4 on the
    card, its plain version on the CPU) as the backward."""
    if v_bm.ndim != 2 or int(v_bm.shape[1]) != plan.M:
        raise ValueError(f"interp_w: v must be (B, {plan.M}), got {tuple(v_bm.shape)}")
    with _interp_span("w", int(v_bm.shape[0]), int(v_bm.shape[1])):
        if torch.is_grad_enabled() and v_bm.requires_grad:
            return _InterpW.apply(plan, v_bm)
        return interp_matvec_bm_fast(plan, v_bm)  # a solver's apply: no graph to build
