"""Structured linear algebra, solvers and the hand-written CUDA kernels (``ops.cuda``).

``__all__`` is the namespace: the JAX package's ``gp_grief_tpu.ops.__all__``
less the names ROADMAP.md records as not ported (``safe_batch_op``, the
one-hot Wᵀ plan, the ``*_segmented`` solver drivers) and ``lanczos``, which
stays the module here; plus the port's own (``fused_cg_slq``,
``check_whitening``, ``pivoted_cholesky_matfree``, ``cholesky``).
"""

from gp_grief_tpu_torch.ops.cg import CGInfo, cg_solve, cg_solve_refined
from gp_grief_tpu_torch.ops.compose import op_product, op_scale, op_shift, op_sum
from gp_grief_tpu_torch.ops.fused import fused_cg_slq
from gp_grief_tpu_torch.ops.interp import (
    InterpPlan,
    InterpWeights,
    build_corner_stream,
    build_interp_plan,
    interp_expand,
    interp_matvec,
    interp_matvec_bm,
    interp_matvec_bm_fast,
    interp_rmatvec,
    interp_rmatvec_bm,
    interp_rmatvec_bm_exact,
    interp_rmatvec_bm_fast,
    interp_weights,
)
from gp_grief_tpu_torch.ops.khatri_rao import (
    kr_expand,
    kr_matvec,
    kr_rmatvec,
    rowcol_kr_expand,
    rowcol_kr_matvec,
    rowcol_kr_rmatvec,
)
from gp_grief_tpu_torch.ops.kron import (
    kron_chol,
    kron_diag,
    kron_eigh,
    kron_expand,
    kron_logdet_from_chol,
    kron_logdet_from_eigs,
    kron_matmat,
    kron_matvec,
    kron_shapes,
    kron_solve_schur,
    kron_svd,
)
from gp_grief_tpu_torch.ops.kron_fast import group_factors, kron_matvec_fast
from gp_grief_tpu_torch.ops.precond import (
    check_whitening,
    kron_deflation_preconditioner,
    kron_deflation_sqrt_ops,
    lowrank_preconditioner,
    lowrank_spectral_factor,
    lowrank_sqrt_ops,
    lowrank_sqrt_ops_from_factor,
    pivoted_cholesky,
    pivoted_cholesky_matfree,
)
# ``ops.lanczos`` stays the module (its ``rademacher`` is the probes' one draw).
from gp_grief_tpu_torch.ops.lanczos import LanczosResult, lanczos_batched, slq_logdet
from gp_grief_tpu_torch.ops.selection import select_rows, select_rows_t, selection_expand
from gp_grief_tpu_torch.ops.solve import cholesky, logdet_from_chol, solve_chol, stable_cholesky
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs

__all__ = [
    "CGInfo", "cg_solve", "cg_solve_refined", "fused_cg_slq", "check_whitening",
    "op_product", "op_sum", "op_scale", "op_shift",
    "InterpPlan", "InterpWeights", "build_corner_stream", "build_interp_plan", "interp_expand", "interp_matvec",
    "interp_matvec_bm", "interp_matvec_bm_fast", "interp_rmatvec", "interp_rmatvec_bm", "interp_rmatvec_bm_exact",
    "interp_rmatvec_bm_fast", "interp_weights",
    "kr_expand", "kr_matvec", "kr_rmatvec", "rowcol_kr_expand", "rowcol_kr_matvec", "rowcol_kr_rmatvec",
    "kron_chol", "kron_diag", "kron_eigh", "kron_expand", "kron_logdet_from_chol", "kron_logdet_from_eigs",
    "kron_matmat", "kron_matvec", "kron_shapes", "kron_solve_schur", "kron_svd", "group_factors", "kron_matvec_fast",
    "kron_deflation_preconditioner", "kron_deflation_sqrt_ops", "lowrank_preconditioner",
    "lowrank_spectral_factor", "lowrank_sqrt_ops", "lowrank_sqrt_ops_from_factor", "pivoted_cholesky",
    "pivoted_cholesky_matfree", "LanczosResult", "lanczos_batched", "slq_logdet",
    "select_rows", "select_rows_t", "selection_expand",
    "cholesky", "logdet_from_chol", "solve_chol", "stable_cholesky", "top_p_kron_eigs",
]
