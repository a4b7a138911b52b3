"""Structured linear algebra, solvers and the hand-written CUDA kernels (``ops.cuda``)."""

from gp_grief_tpu_torch.ops.cg import CGInfo, cg_solve, cg_solve_refined
from gp_grief_tpu_torch.ops.khatri_rao import kr_expand, kr_matvec
from gp_grief_tpu_torch.ops.kron import (
    kron_diag,
    kron_eigh,
    kron_expand,
    kron_logdet_from_eigs,
    kron_matmat,
    kron_matvec,
    kron_shapes,
    kron_solve_schur,
)
from gp_grief_tpu_torch.ops.kron_fast import group_factors, kron_matvec_fast
from gp_grief_tpu_torch.ops.precond import kron_deflation_preconditioner, kron_deflation_sqrt_ops
from gp_grief_tpu_torch.ops.solve import cholesky, logdet_from_chol, solve_chol, stable_cholesky
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs

__all__ = [
    "CGInfo", "cg_solve", "cg_solve_refined", "kr_expand", "kr_matvec",
    "kron_diag", "kron_eigh", "kron_expand", "kron_logdet_from_eigs", "kron_matmat", "kron_matvec",
    "kron_shapes", "kron_solve_schur", "group_factors", "kron_matvec_fast",
    "kron_deflation_preconditioner", "kron_deflation_sqrt_ops",
    "cholesky", "logdet_from_chol", "solve_chol", "stable_cholesky", "top_p_kron_eigs",
]
