"""Structured linear algebra and the hand-written CUDA kernels (``ops.cuda``)."""

from gp_grief_tpu_torch.ops.kron import kron_eigh, kron_expand
from gp_grief_tpu_torch.ops.solve import cholesky, logdet_from_chol, solve_chol, stable_cholesky
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs

__all__ = [
    "kron_eigh", "kron_expand", "cholesky", "logdet_from_chol", "solve_chol",
    "stable_cholesky", "top_p_kron_eigs",
]
