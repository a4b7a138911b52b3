"""The Kronecker matvec of the solvers' hot loops, dispatched to the kernels.

Counterpart of ``gp_grief_tpu.ops.kron_fast``.  :func:`kron_matvec_fast`
sends a product to kernel K2 (:func:`~gp_grief_tpu_torch.ops.cuda.kron.kron_matvec_slab`)
or K3 (:func:`~gp_grief_tpu_torch.ops.cuda.kron.kron_matvec_fused`) by the
Hopper gate (:func:`kernel_route`, :func:`hopper_gate`): what the kernels'
pass plan takes, and where this card's measurements put the kernel ahead of
the chain or the JAX package sends the product to a Pallas kernel.  Otherwise
it runs the grouped cyclic chain: adjacent square factors merged into
~1024-wide super-factors (:func:`group_factors`), one ``torch.matmul`` per
super-factor, each pass writing its axis last so the lattice order is
restored after one pass per factor.  The solvers' batch identity
(:func:`batch_identity`, the ``(I_B, *factors)`` call form) is folded into
the kernels' rows; the chain and the CPU contract it as the matrix it is.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch

from gp_grief_tpu_torch.ops.cuda.kron import (
    batch_identity,
    kernel_for,
    kron_matvec_fused,
    kron_matvec_slab,
    plan_takes,
    split_lead,
    tile_only,
)
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["batch_identity", "group_factors", "hopper_gate", "kernel_route", "kron_matvec_fast"]

PRECISIONS = ("highest", "default")
# The JAX package's lax.DotAlgorithmPreset.BF16_BF16_F32_X3, by name.
X3 = "BF16_BF16_F32_X3"
_kron_span = _prof.site("gp_grief.kron", "route", "B", "M", "grade")


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
        if p == X3.lower():
            return X3
    raise ValueError(
        f"precision must be one of {PRECISIONS}, {X3!r} (or None for 'default'), got {precision!r}"
    )


def _bf16_operands(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t


# The Hopper gate (:func:`hopper_gate`); PERF.md's routing table gives the
# measurements behind each class.
MIN_ELEMENTS = 1 << 12  # lead·M·B below this: launch-bound either way, the chain
# The JAX package's exact-grade fused class, less its VMEM plan: a factor (the
# batch identity included) of 512 points or more, 2^21 elements, and every
# factor under 2^22 elements (its plan takes up to 1920², so 2048² is out).
WIDE_MIN_POINTS, WIDE_MIN_ELEMENTS, WIDE_MAX_FACTOR = 512, 1 << 21, 1 << 22
# The JAX package's slab class, less its lane rules: square, three factors or
# more (the batch identity included), the leading ones (the identity too) at
# most 128 points, the trailing pair times B 128-2048 elements, 2^18 elements.
SLAB_MAX_LEAD, SLAB_PAIR, SLAB_MIN_ELEMENTS = 128, (128, 2048), 1 << 18


def _slab_form(ms: tuple, outs: tuple, B: int, lead: int) -> bool:
    """Whether ``(I_lead ⊗ (⊗ K_d))`` has the JAX package's slab-class form
    (a superset: its TPU lane rules left out)."""
    axes = ((lead,) if lead > 1 else ()) + ms
    return (ms == outs and len(axes) >= 3 and max(axes[:-2]) <= SLAB_MAX_LEAD
            and SLAB_PAIR[0] <= axes[-2] * axes[-1] * B <= SLAB_PAIR[1]
            and lead * math.prod(ms) * B >= SLAB_MIN_ELEMENTS)


@functools.lru_cache(maxsize=1024)
def hopper_gate(ms: tuple, outs: tuple, B: int, lead: int, grade: str) -> bool:
    """Whether a product the Hopper plan takes runs on K2/K3 rather than the
    chain: factors ``(o_d, m_d)`` behind a folded batch identity of ``lead``
    rows, ``B`` columns, at ``grade`` ``"exact"`` ("highest" with a float32
    vector), ``"x3"`` (X3 with a float32 vector; exact f32 on both routes, as
    "highest"), ``"fast"`` ("default" with a float32 vector) or ``"bf16"`` (a
    bf16 vector, the fast grade).  Two rules: (a) every product the JAX
    package runs on a Pallas kernel runs on K2/K3, whatever the timing; (b)
    any other only where this card's measurements put the kernel ahead.

    - Under ``MIN_ELEMENTS`` elements (``lead·M·B``): the chain (the JAX
      package's kernels start there too).
    - ``"fast"`` and ``"bf16"``: the kernel, tile and wide passes alike; a
      superset of the JAX package's slab and fast fused classes (rule a).
      At "default" measured faster than the chain (whose float32 GEMMs take
      bf16-rounded operands) at the other shapes tried (rule b).  A bf16
      vector is one class, though cuBLAS's bf16 GEMMs beat K2 on batches of
      16-32 rows of 32⁴ (0.68-0.93×): 25-32 rows by rule (a), 17-24 (where
      the JAX package's padding meets its slab's lane rule) a recorded
      departure from rule (b) (ROADMAP).
    - ``"exact"``/``"x3"``, every pass a tile pass (every axis at most 64
      points): the kernel.  The exact tile member's FP32 FMA against the
      chain's FP32 GEMMs over merged ~1024-wide blocks (which also multiply
      the batch identity's zeros): faster at every such shape tried (rule b).
    - ``"exact"``/``"x3"`` with a wide pass: the kernel in the JAX package's
      exact-grade fused class (``WIDE_*``, rule a), although the wide
      member's 3xTF32 loses to the chain's FP32 GEMMs there ((I₈, 1024²):
      0.67×; 1920²: 0.60×); ``"x3"`` also in its slab class (``SLAB_*``,
      rule a; 0.65-7.0× the chain).  The chain elsewhere (2048²: 0.61×).

    The classes count the batch identity's rows as the JAX package's
    ``safe_batch_op`` pads them (over 8: to a multiple of 8), so that they
    hold its padded products too.  The figures: ``tools/route_probe.py``
    (PERF.md §6)."""
    lead = lead if lead <= 8 else -(-lead // 8) * 8
    elements = lead * math.prod(ms) * B
    if elements < MIN_ELEMENTS:
        return False
    if grade in ("fast", "bf16") or tile_only(ms, outs, B):
        return True
    wide = (max(lead, *ms) >= WIDE_MIN_POINTS and elements >= WIDE_MIN_ELEMENTS
            and max(o * m for o, m in zip(outs, ms)) < WIDE_MAX_FACTOR)
    return wide or (grade == "x3" and _slab_form(ms, outs, B, lead))


def kernel_route(factors: Sequence[torch.Tensor], B: int, precision="highest", *, vector_dtype=torch.float32,
                 impl: str = "auto") -> str:
    """Where :func:`kron_matvec_fast` sends ``(⊗K_d)·V`` (``V`` ``(M, B)``)
    for tensors on the card: ``"slab"`` (K2), ``"fused"`` (K3) or
    ``"chain"``, by the Hopper gate (:func:`hopper_gate`).  The kernels need
    float32 factors, a float32/bfloat16 vector and a product the Hopper pass
    plan takes (``ops.cuda.kron.plan_takes``); ``vector_dtype=None`` stands
    for a vector off the card (always the chain).  Of the two kernels, K2
    takes square factors, d ≥ 3, every axis on the tile members; K3 the rest
    (``ops.cuda.kron.kernel_for``).  A leading ``batch_identity`` is folded
    into the plan's rows before any of this.  Reads shapes and dtypes only,
    never a tensor's values.  Raises where ``impl`` forces a kernel that
    does not take the product."""
    precision = _normalize_precision(precision)
    lead, core = split_lead(factors)
    fast = precision == "default" or vector_dtype == torch.bfloat16
    takes = (vector_dtype in (torch.float32, torch.bfloat16) and all(K.dtype == torch.float32 for K in core)
             and plan_takes(factors, B, fast=fast))
    kernel = kernel_for(factors, B) if takes else None
    if impl in ("slab", "fused"):
        square = len(core) >= 3 and all(K.shape[0] == K.shape[1] for K in core)
        if kernel is None or (impl == "slab" and not square):
            raise ValueError(f"kron_matvec_fast(impl={impl!r}) needs CUDA float32 factors, a float32/bfloat16 "
                             "vector and a product the Hopper plan takes"
                             + (" (K2: d >= 3 square factors)" if impl == "slab" else ""))
        return impl
    if kernel is not None:
        ms = tuple(int(K.shape[1]) for K in core)
        grade = ("bf16" if vector_dtype == torch.bfloat16 else "fast" if fast
                 else "x3" if precision == X3 else "exact")
        if hopper_gate(ms, tuple(int(K.shape[0]) for K in core), int(B), lead, grade):
            return kernel
    return "chain"


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

    - ``"highest"`` (default): exact f32 on every route (TF32 stays off).
    - ``"default"`` (or ``None``): bf16 operands, f32 accumulation.  On K2
      with bf16 storage between passes; on the chain, passes of width ≥ 128
      round their operands to bf16.  This is the operating point of the
      refined-CG inner loop.
    - ``"BF16_BF16_F32_X3"`` (the JAX package's ``DotAlgorithmPreset``, the
      SKI lattice dual's Q/Qᵀ applies): exact f32 on every route, as the JAX
      package upgrades X3 on a TPU; routed as "highest".

    On CUDA tensors :func:`kernel_route` picks K2, K3 or the chain; on the
    CPU the chain always runs.  A bfloat16 ``v`` (the mixed16 CG state)
    takes the fast grade wherever a kernel runs.  The kernels take float32
    or bfloat16 vectors with float32 factors; float64 always runs the chain.
    A leading :func:`batch_identity` is folded into the kernels' rows, never
    contracted as a matrix there.

    ``impl``: ``"auto"`` (as above), ``"xla"`` (force the chain; the name is
    the JAX package's), ``"slab"`` / ``"fused"`` (force K2 / K3; raise where
    they do not take the product).
    """
    precision = _normalize_precision(precision)
    if impl not in ("auto", "xla", "slab", "fused"):
        raise ValueError(f"impl must be 'auto', 'xla', 'slab' or 'fused', got {impl!r}")
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    B = int(v.shape[1])
    route = "chain" if impl == "xla" else kernel_route(factors, B, precision,
                                                       vector_dtype=v.dtype if v.is_cuda else None, impl=impl)
    with _kron_span(route, B, int(v.shape[0]), precision):
        if route != "chain":
            fast = precision == "default"
            if route == "slab":
                # At the fast grade ("default", or a bf16 vector at any
                # precision) the passes store bf16 between them: the next
                # pass rounds its operand to bf16 anyway, so the bits are
                # those of float32 storage.  X3 runs exact f32.
                mid = torch.bfloat16 if fast or v.dtype == torch.bfloat16 else None
                out = kron_matvec_slab(factors, v, precision="default" if fast else "highest", mid_dtype=mid)
            else:
                out = kron_matvec_fused(factors, v, precision="default" if fast else "highest")
            return out[:, 0] if squeeze else out
        gf = group_factors(factors, target_width=target_width)
        rows = math.prod(int(K.shape[0]) for K in gf)
        x = v
        for K in gf:
            mk = int(K.shape[1])
            X = x.reshape(mk, -1)  # (mk, rest·B)
            K = K.to(X.dtype)
            # Narrow (< 128) passes run at full precision, as in the JAX
            # chain; the fast grade applies to the wide passes only.
            if precision == "default" and mk >= 128:
                X, K = _bf16_operands(X), _bf16_operands(K)
            x = X.T @ K.T  # (rest·B, mk'): the contracted axis moves last
        out = x.reshape(B, rows)
        return out[0] if squeeze else out.T
