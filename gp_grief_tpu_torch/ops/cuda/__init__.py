"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` at
first use (``_build.py``) and bound with ctypes.

* K1 :func:`phi_fused` — fused GRIEF Φ assembly (replaces
  ``gp_grief_tpu/ops/pallas/phi_pallas.py:_phi_fused_primal``).
"""

from gp_grief_tpu_torch.ops.cuda.phi import phi_fused, phi_fused_ref

__all__ = ["phi_fused", "phi_fused_ref"]
