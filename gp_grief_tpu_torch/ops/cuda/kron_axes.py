"""Kernels K6, K7 and K8: per-axis Kronecker passes on the card.

Counterparts of three public entry points and pass kernels of
``gp_grief_tpu/ops/pallas/kron_pallas.py``:

* K7 :func:`kron_matmat_cuda` / :func:`kron_matvec_cuda` —
  ``kron_matmat_pallas`` / ``kron_matvec_pallas`` (``:217-244``), whose
  ``_kmm_primal`` (``:158``) runs one ``_mid_axis_pass`` (``:108``) or
  ``_last_axis_pass`` (``:132``) per factor;
* K6 :func:`last_slab_pass` — ``last_slab_pass`` (``:46``), ``x2 @ Wᵀ``;
* K8 :func:`tail3_pass` / :func:`tail2_pass` — ``_tail3_pass`` (``:525``)
  and ``_tail2_pass`` (``:590``), the last three or two axes of a block in
  one visit.

On Hopper these are the same contractions as K2 and K3, so they launch the
same two hand-written members of ``csrc/kron_pass.cu`` (the tile member for
groups of up to three axes of at most 64 points, the wide member, a
tensor-core GEMM, for wider axes), planned by
:func:`~gp_grief_tpu_torch.ops.cuda.kron._hopper_plan`.  What differs from
K2/K3 is what each entry takes and its launch counter.  The TPU kernels'
per-factor order, their ``post >= 128 or pre == 1`` test, the narrow-tail
``K ⊗ I_post`` widening (``kron_pallas.py:167-176``), ``last_slab_pass``'s
XLA fallback when N has no power-of-two block of at least 8 rows
(``:58-63``) and the ``BP``/``block_rows`` knobs are Mosaic layout and VMEM
rules with no counterpart here: every shape takes the kernels.

Each entry checks its operands and then

* on CPU tensors runs its plain version (:func:`kron_chain_ref`,
  :func:`last_slab_pass_ref`, :func:`tail3_pass_ref`, :func:`tail2_pass_ref`);
* on CUDA tensors launches the kernels on the current stream, or raises
  (``TypeError`` for a dtype other than float32, or bf16 at the fast grade;
  ``RuntimeError`` naming the shape for a pass a member does not take).  It
  never falls back to the plain version on the card.

Grades: ``"highest"`` is float32-accurate (FP32 FMA in the tile member,
3xTF32 tensor-core products in the wide one); ``"default"`` rounds every
operand of every contraction to bf16 and accumulates in f32, standing for
the TPU's one-pass bf16 DEFAULT.  A bf16 input forces ``"default"`` and gives
a bf16 result.  K7 is differentiable (the backward pass is the exact plain
chain's VJP, as ``_kmm_bwd`` is an XLA chain); K6 and K8 are forward only,
as no JAX caller differentiates them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gp_grief_tpu_torch.ops.cuda.kron import _apply, _check, _grade, _launch, kron_chain_ref

__all__ = [
    "kron_matmat_cuda",
    "kron_matvec_cuda",
    "last_slab_pass",
    "last_slab_pass_ref",
    "tail3_pass",
    "tail3_pass_ref",
    "tail2_pass",
    "tail2_pass_ref",
]


def kron_matmat_cuda(factors: Sequence[torch.Tensor], v: torch.Tensor, *, precision: str = "highest") -> torch.Tensor:
    """K7: ``(⊗ K_d) · v`` for any d ≥ 1 and square or rectangular factors;
    ``v`` ``(M,)`` or ``(M, B)``.  Differentiable w.r.t. the factors and
    ``v``.  Counterpart of ``kron_pallas.py:217 kron_matmat_pallas``."""
    _check("kron_matmat_cuda", factors, v)
    squeeze = v.ndim == 1
    vv = v[:, None] if squeeze else v
    out = _apply(kron_matmat_cuda, _grade(precision, v), None, vv, factors)
    return out[:, 0] if squeeze else out


def kron_matvec_cuda(factors: Sequence[torch.Tensor], v: torch.Tensor, *, precision: str = "highest") -> torch.Tensor:
    """Single-vector alias of :func:`kron_matmat_cuda`, which takes ``v``
    ``(M,)`` as well (its launches count there).  It mirrors the JAX
    package's public pair: ``kron_pallas.py:237 kron_matvec_pallas`` is the
    same alias of ``kron_matmat_pallas``, and a caller of either name finds
    its counterpart here."""
    return kron_matmat_cuda(factors, v, precision=precision)


def _axes_pass(which, factors, x: torch.Tensor, lead: int, precision: str, plain, shape, plan=None) -> torch.Tensor:
    """``(I_lead ⊗ (⊗ K_d))`` applied to ``x`` (lead rows, the contracted
    axes trailing), forward only: the kernels on a CUDA ``x``, ``plain(x,
    fast)`` on a CPU one.  Returns the result in ``shape``."""
    device = x.device
    for K in factors:
        if K.ndim != 2:
            raise ValueError(f"{which.__name__}: factors must be matrices")
        if K.device != device:
            raise ValueError(f"{which.__name__}: factors and input on different devices")
    fast = _grade(precision, x)
    if x.is_cuda:  # the launches build no autograd graph
        return _launch(which, factors, x, fast, None, 1, lead=lead, plan=plan).reshape(shape)
    if device.type == "cpu":
        with torch.no_grad():
            return plain(x, fast).reshape(shape)
    raise ValueError(f"{which.__name__}: no kernel for device {device}")


def last_slab_pass(x2: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """K6: ``x2 @ Wᵀ`` for ``x2`` ``(N, S)`` and ``W`` ``(S′, S)`` (typically
    ``I_G ⊗ K``), any N; x2's dtype.  One launch of the wide member
    (``C = X·Wᵀ``).  Counterpart of ``kron_pallas.py:46 last_slab_pass``."""
    if x2.ndim != 2 or W.ndim != 2 or W.shape[1] != x2.shape[1]:
        raise ValueError(f"last_slab_pass: x2 (N, S) and W (S', S), got {tuple(x2.shape)} and {tuple(W.shape)}")
    N = x2.shape[0]
    return _axes_pass(last_slab_pass, [W], x2, N, "highest", lambda x, fast: last_slab_pass_ref(x, W, fast=fast),
                      (N, W.shape[0]), plan=((0, 0, 0),))


def last_slab_pass_ref(x2: torch.Tensor, W: torch.Tensor, *, fast: bool = False) -> torch.Tensor:
    """Plain version of K6: ``x2 @ Wᵀ`` in float64 for float64 input, else
    float32 (``fast``: both operands rounded to bf16); x2's dtype."""
    work = torch.float64 if x2.dtype == torch.float64 else torch.float32
    x, w = x2.to(work), W.to(work)
    if fast or x2.dtype == torch.bfloat16:
        x, w = x.to(torch.bfloat16).to(work), w.to(torch.bfloat16).to(work)
    return (x @ w.T).to(x2.dtype)


def _tail(which, x: torch.Tensor, Ks, precision: str) -> torch.Tensor:
    g = len(Ks)
    if x.ndim != g + 1 or tuple(x.shape[1:]) != tuple(int(K.shape[1]) for K in Ks):
        raise ValueError(f"{which.__name__}: x {tuple(x.shape)} does not match factors {[tuple(K.shape) for K in Ks]}")
    N = x.shape[0]
    return _axes_pass(which, Ks, x, N, precision, lambda xx, fast: _tail_ref(xx, Ks, fast),
                      (N, *(K.shape[0] for K in Ks)))


def tail3_pass(x4: torch.Tensor, K3: torch.Tensor, K4: torch.Tensor, K5: torch.Tensor, *,
               precision: str = "highest") -> torch.Tensor:
    """K8: ``(N, m3, m4, m5) → (N, o3, o4, o5)``, the last three axes
    contracted with ``K3``, ``K4``, ``K5`` (``(o, m)`` each); x4's dtype.
    One tile pass where the three axes fit shared memory, else a chain of
    tile and wide passes.  Counterpart of ``kron_pallas.py:525 _tail3_pass``."""
    return _tail(tail3_pass, x4, (K3, K4, K5), precision)


def tail2_pass(x3: torch.Tensor, K4: torch.Tensor, K5: torch.Tensor, *, precision: str = "highest") -> torch.Tensor:
    """K8: ``(N, m4, m5) → (N, o4, o5)``; as :func:`tail3_pass` for two
    axes.  Counterpart of ``kron_pallas.py:590 _tail2_pass``."""
    return _tail(tail2_pass, x3, (K4, K5), precision)


def _tail_ref(x: torch.Tensor, Ks, fast: bool) -> torch.Tensor:
    N = int(x.shape[0])
    out = kron_chain_ref(Ks, x.reshape(N, -1).T, fast=fast).T  # the N rows as N trailing columns
    return out.reshape(N, *(int(K.shape[0]) for K in Ks))


def tail3_pass_ref(x4, K3, K4, K5, *, precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`tail3_pass`: an einsum chain from the last
    axis to the first (the kernel's order and rounding points)."""
    return _tail_ref(x4, (K3, K4, K5), _grade(precision, x4))


def tail2_pass_ref(x3, K4, K5, *, precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`tail2_pass`."""
    return _tail_ref(x3, (K4, K5), _grade(precision, x3))


kron_matmat_cuda.launches = kron_matmat_cuda.exact_tile_launches = 0
last_slab_pass.launches = 0
tail3_pass.launches = tail3_pass.exact_tile_launches = 0
tail2_pass.launches = tail2_pass.exact_tile_launches = 0
