"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` at
first use (``_build.py``) and bound with ctypes.

* K1 :func:`phi_fused` — fused GRIEF Φ assembly (replaces
  ``gp_grief_tpu/ops/pallas/phi_pallas.py:_phi_fused_primal``).
* K2 :func:`kron_matvec_slab` and K3 :func:`kron_matvec_fused` — the
  Kronecker matvec (``csrc/kron_pass.cu``; replace ``kron_pallas.py``'s
  slab and general fused schedules).
* K6 :func:`last_slab_pass`, K7 :func:`kron_matmat_cuda` /
  :func:`kron_matvec_cuda` and K8 :func:`tail3_pass` / :func:`tail2_pass` —
  per-axis Kronecker passes on the same kernel family (``kron_axes.py``;
  replace ``kron_pallas.py``'s ``last_slab_pass``, ``_mid_axis_pass`` /
  ``_last_axis_pass`` and ``_tail3_pass`` / ``_tail2_pass``).
* K4 :func:`interp_wt` — the SKI interpolation transpose ``Wᵀu``
  (``csrc/interp_wt.cu``; replaces ``gp_grief_tpu/ops/interp.py:make_onehot_rmatvec``).
* K5 :func:`wtw_stencil` — the SKI ``WᵀW`` stencil (``csrc/wtw_stencil.cu``;
  replaces ``gp_grief_tpu/ops/interp_stencil.py:_apply_pallas``).
* K9 :func:`gram_apply` — the matrix-free Gram apply of the exact GP, one
  pass with no slab in device memory (``csrc/gram_apply.cu``; replaces no
  TPU kernel: the JAX package leaves the apply to XLA).
* K10 :func:`gram_grad` — the hyperparameter cotangents of that apply, one
  pass with no slab in device memory (``csrc/gram_grad.cu``; replaces no
  TPU kernel: the JAX package leaves the gradient to XLA's autodiff).
"""

from gp_grief_tpu_torch.ops.cuda.gram import gram_apply, gram_grad
from gp_grief_tpu_torch.ops.cuda.interp import interp_wt
from gp_grief_tpu_torch.ops.cuda.kron import (
    fused_schedule_applicable,
    kron_chain_ref,
    kron_matvec_fused,
    kron_matvec_slab,
    slab_schedule_applicable,
)
from gp_grief_tpu_torch.ops.cuda.kron_axes import (
    kron_matmat_cuda,
    kron_matvec_cuda,
    last_slab_pass,
    last_slab_pass_ref,
    tail2_pass,
    tail2_pass_ref,
    tail3_pass,
    tail3_pass_ref,
)
from gp_grief_tpu_torch.ops.cuda.phi import phi_fused, phi_fused_ref
from gp_grief_tpu_torch.ops.cuda.stencil import wtw_stencil

__all__ = [
    "phi_fused", "phi_fused_ref", "kron_chain_ref", "kron_matvec_slab", "kron_matvec_fused",
    "slab_schedule_applicable", "fused_schedule_applicable", "kron_matmat_cuda", "kron_matvec_cuda",
    "last_slab_pass", "last_slab_pass_ref", "tail3_pass", "tail3_pass_ref", "tail2_pass", "tail2_pass_ref",
    "interp_wt", "wtw_stencil", "gram_apply", "gram_grad",
]
