"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` at
first use (``_build.py``) and bound with ctypes.

* K1 :func:`phi_fused` — fused GRIEF Φ assembly (replaces
  ``gp_grief_tpu/ops/pallas/phi_pallas.py:_phi_fused_primal``).
* K2 :func:`kron_matvec_slab` and K3 :func:`kron_matvec_fused` — the
  Kronecker matvec (``csrc/kron_pass.cu``; replace ``kron_pallas.py``'s
  slab and general fused schedules).
"""

from gp_grief_tpu_torch.ops.cuda.kron import (
    fused_schedule_applicable,
    kron_chain_ref,
    kron_matvec_fused,
    kron_matvec_slab,
    slab_schedule_applicable,
)
from gp_grief_tpu_torch.ops.cuda.phi import phi_fused, phi_fused_ref

__all__ = [
    "phi_fused", "phi_fused_ref", "kron_chain_ref", "kron_matvec_slab", "kron_matvec_fused",
    "slab_schedule_applicable", "fused_schedule_applicable",
]
