"""The Kronecker matvec of the solvers' hot loops, dispatched to the kernels.

Counterpart of ``gp_grief_tpu.ops.kron_fast``.  :func:`kron_matvec_fast`
sends a product to kernel K2 (:func:`~gp_grief_tpu_torch.ops.cuda.kron.kron_matvec_slab`)
or K3 (:func:`~gp_grief_tpu_torch.ops.cuda.kron.kron_matvec_fused`) under the
JAX package's own gates, with "the tensors are on CUDA" in place of "the
backend is a TPU", and otherwise runs the grouped cyclic chain: adjacent
square factors merged into ~1024-wide super-factors (:func:`group_factors`),
one ``torch.matmul`` per super-factor, each pass writing its axis last so
the lattice order is restored after one pass per factor.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

__all__ = ["group_factors", "kron_matvec_fast"]

PRECISIONS = ("highest", "default")


def _kron2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    a0, a1 = A.shape
    b0, b1 = B.shape
    return (A[:, None, :, None] * B[None, :, None, :]).reshape(a0 * b0, a1 * b1)


def group_factors(
    factors: Sequence[torch.Tensor],
    target_width: int = 1024,
    max_width: int = 2048,
) -> Tuple[torch.Tensor, ...]:
    """Greedily merge adjacent square factors into ~``target_width`` blocks."""
    out = []
    cur = None
    for K in factors:
        if K.shape[0] != K.shape[1]:
            if cur is not None:
                out.append(cur)
                cur = None
            out.append(K)
            continue
        if cur is None:
            cur = K
        elif int(cur.shape[1]) * int(K.shape[1]) <= max_width:
            cur = _kron2(cur, K)
        else:
            out.append(cur)
            cur = K
        if cur is not None and int(cur.shape[1]) >= target_width:
            out.append(cur)
            cur = None
    if cur is not None:
        out.append(cur)
    return tuple(out)


def _normalize_precision(precision) -> str:
    if precision is None:
        return "default"
    if isinstance(precision, str):
        p = precision.lower()
        if p in PRECISIONS:
            return p
        if p == "bf16_bf16_f32_x3":
            raise NotImplementedError(
                "the BF16_BF16_F32_X3 preset serves SKI, which is not ported yet"
            )
    raise ValueError(f"precision must be one of {PRECISIONS} (or None for 'default'), got {precision!r}")


def _bf16_operands(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t


def kron_matvec_fast(
    factors: Sequence[torch.Tensor],
    v: torch.Tensor,
    *,
    target_width: int = 1024,
    precision="highest",
    impl: str = "auto",
) -> torch.Tensor:
    """``(⊗_d K_d) @ v`` by the fastest applicable formulation; ``v`` ``(M,)``
    or ``(M, B)``.  Differentiable.

    ``precision``:

    - ``"highest"`` (default): exact f32.  On CUDA, shapes in the fused
      schedule's exact-grade class (:func:`fused_schedule_applicable` with
      ``fast=False``: a ≥512-wide factor and ≥2²¹ elements) run K3; all
      others run the cyclic chain.
    - ``"default"`` (or ``None``): bf16 operands, f32 accumulation.  On CUDA,
      slab-applicable shapes run K2 with bf16 storage between passes; shapes
      with a fused plan in the fast class run K3; others run the chain, whose
      passes of width ≥ 128 round their operands to bf16.  This is the
      operating point of the refined-CG inner loop.

    A bfloat16 ``v`` (the mixed16 CG state) takes the fast grade wherever a
    kernel runs.  The JAX package's ``BF16_BF16_F32_X3`` preset (SKI) raises
    ``NotImplementedError``.  The kernels take float32 or bfloat16 vectors
    with float32 factors; float64 always runs the chain.

    ``impl``: ``"auto"`` (as above), ``"xla"`` (force the chain; the name is
    the JAX package's), ``"slab"`` / ``"fused"`` (force K2 / K3; raise where
    they do not apply).
    """
    precision = _normalize_precision(precision)
    if impl not in ("auto", "xla", "slab", "fused"):
        raise ValueError(f"impl must be 'auto', 'xla', 'slab' or 'fused', got {impl!r}")
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    B = int(v.shape[1])
    if impl != "xla":
        from gp_grief_tpu_torch.ops.cuda.kron import (
            fused_schedule_applicable,
            kron_matvec_fused,
            kron_matvec_slab,
            slab_schedule_applicable,
        )

        # "The backend is a TPU" in the JAX package; here the kernels also
        # need float32 factors and a float32/bfloat16 vector.
        on_card = (
            v.is_cuda
            and v.dtype in (torch.float32, torch.bfloat16)
            and all(K.dtype == torch.float32 for K in factors)
        )
        applicable = on_card and slab_schedule_applicable(factors, B)
        if impl == "slab" and not applicable:
            raise ValueError(
                "kron_matvec_fast(impl='slab') needs CUDA float32/bfloat16 tensors and "
                "slab_schedule_applicable shapes"
            )
        if applicable and precision == "default":
            out = kron_matvec_slab(factors, v, precision="default", mid_dtype=torch.bfloat16)
            return out[:, 0] if squeeze else out
        fast_point = precision == "default" or v.dtype == torch.bfloat16
        fused_ok = (
            impl in ("auto", "fused")
            and not applicable
            and on_card
            and fused_schedule_applicable(factors, B, fast=fast_point, feasible_only=impl == "fused")
        )
        if impl == "fused" and not fused_ok:
            raise ValueError(
                "kron_matvec_fast(impl='fused') needs CUDA float32/bfloat16 tensors and a "
                "feasible fused plan (with the slab schedule inapplicable)"
            )
        if fused_ok:
            out = kron_matvec_fused(factors, v, precision=precision)
            return out[:, 0] if squeeze else out
    gf = group_factors(factors, target_width=target_width)
    rows = math.prod(int(K.shape[0]) for K in gf)
    x = v
    for K in gf:
        mk = int(K.shape[1])
        X = x.reshape(mk, -1)  # (mk, rest·B)
        K = K.to(X.dtype)
        # Narrow (< 128) passes run at full precision, as in the JAX chain;
        # the fast grade applies to the wide passes only.
        if precision == "default" and mk >= 128:
            X, K = _bf16_operands(X), _bf16_operands(K)
        x = X.T @ K.T  # (rest·B, mk'): the contracted axis moves last
    out = x.reshape(B, rows)
    return out[0] if squeeze else out.T
