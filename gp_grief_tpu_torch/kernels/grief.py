"""GRIEF eigenfunction basis: grid-structured Nyström features.

Counterpart of ``gp_grief_tpu.kernels.grief``.  The kernel is a truncated
Nyström eigenfunction expansion on a Cartesian inducing grid,
``k(x, z) = Σ_j w_j φ_j(x) φ_j(z)`` with ``φ_j(x) = λ_j^{-1/2} k(x, U) q_j``
and ``(λ_j, q_j)`` the top-p eigenpairs of ``K_UU = ⊗_d K_d``.  Because
``q_j`` factorizes, the feature matrix is

    Φ[i, j] = Π_d ( [K_xU_d Q_d][i, idx[j,d]] · λ_{d, idx[j,d]}^{-1/2} ),

normalized per dimension inside the product so intermediates stay O(1).
Everything is differentiable in the kernel hyperparameters (batched ``eigh``,
log-space top-p selection, the products), which is what
``opt_kernel_params=True`` trains through.

Φ assembly paths (:func:`phi`): the fused kernel K1 on CUDA tensors
(:func:`gp_grief_tpu_torch.ops.cuda.phi_fused`), the batched einsum when the
dimensions stack, and the per-dimension loop otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from gp_grief_tpu_torch.kernels.grid import KernList, cov_grid, cross_cov_grid
from gp_grief_tpu_torch.kernels.stationary import StackedKernel, Stationary
from gp_grief_tpu_torch.ops.cuda.phi import phi_fused
from gp_grief_tpu_torch.ops.kron import kron_eigh
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = ["GriefBasis", "build_basis", "phi", "stack_kernels"]

_basis_span = _prof.site("gp_grief.grief.basis")
_phi_span = _prof.site("gp_grief.grief.phi", "rows", "p", "route")


@dataclasses.dataclass(frozen=True)
class GriefBasis:
    """Eigenfunction basis state.

    * ``Qs``: per-dimension eigenvector matrices ``(m_d, m_d)``.
    * ``lams``: per-dimension eigenvalue vectors ``(m_d,)`` (ascending).
    * ``log_lam``: ``(p,)`` selected ``log Π_d λ``, descending.
    * ``idx``: ``(p, d)`` int64 per-dimension eigenvector column selections.
    """

    Qs: Tuple[torch.Tensor, ...]
    lams: Tuple[torch.Tensor, ...]
    log_lam: torch.Tensor
    idx: torch.Tensor


def _as_list(kernels, d):
    return list(kernels) if isinstance(kernels, (list, tuple, torch.nn.ModuleList)) else [kernels] * d


def stack_kernels(kernels: Union[Stationary, KernList], xg, dims=None) -> Optional[StackedKernel]:
    """Stack per-dimension kernels along a leading ``(d,)`` axis, or ``None``
    when the dimensions cannot batch (grouped dims, unequal grids, fewer than
    two dims, mixed kernel kinds or parameter shapes).  The batched form turns
    d covariance builds, eighs and Φ factors into one op each, which keeps the
    backward pass of high-d ARD training short."""
    if dims is not None:
        return None
    if any(g.shape != xg[0].shape for g in xg):
        return None
    ks = _as_list(kernels, len(xg))
    if len(ks) != len(xg) or len(ks) < 2:
        return None
    k0 = ks[0]
    if not all(isinstance(k, Stationary) and k.kind == k0.kind for k in ks):
        return None
    shapes0 = (k0.log_lengthscale.shape, k0.log_variance.shape)
    if any((k.log_lengthscale.shape, k.log_variance.shape) != shapes0 for k in ks[1:]):
        return None
    return StackedKernel(
        k0.kind,
        torch.stack([k.log_lengthscale for k in ks]),
        torch.stack([k.log_variance for k in ks]),
    )


def build_basis(
    kernels: Union[Stationary, KernList],
    xg: Sequence[torch.Tensor],
    p: int,
    *,
    dim_noise_var: float = 1e-12,
) -> GriefBasis:
    """Build the eigenfunction basis: d small ``eigh``s + top-p selection.

    ``p`` is clamped to the lattice size when that is countable.
    ``dim_noise_var`` is the per-dimension jitter that keeps both the factor
    ``eigh`` and its gradient finite at near-degenerate eigenvalues.
    """
    log_total = sum(math.log(int(g.shape[0])) for g in xg)
    if log_total < math.log(2**62):
        p = min(p, math.prod(int(g.shape[0]) for g in xg))
    with _basis_span():
        stacked = stack_kernels(kernels, xg)
        if stacked is not None:
            g_stack = torch.stack(list(xg))  # (d, m, s)
            Ks = stacked(g_stack)  # (d, m, m)
            if dim_noise_var:
                Ks = Ks + dim_noise_var * torch.eye(Ks.shape[-1], dtype=Ks.dtype, device=Ks.device)
            lams_st, Qs_st = torch.linalg.eigh(Ks)
            Qs, lams = tuple(Qs_st.unbind(0)), tuple(lams_st.unbind(0))
        else:
            Qs, lams = kron_eigh(cov_grid(kernels, xg, dim_noise_var=dim_noise_var))
        log_lam, idx = top_p_kron_eigs(lams, p)
    return GriefBasis(Qs=Qs, lams=lams, log_lam=log_lam, idx=idx)


def _phi_fused_applicable(xg, dims) -> bool:
    """K1 needs equal per-dimension grids, the trivial dim mapping and d ≥ 2."""
    if dims is not None or len(xg) < 2:
        return False
    m0 = int(xg[0].shape[0])
    return all(int(g.shape[0]) == m0 for g in xg)


def _onehot_cols(cols: torch.Tensor, m: int, dtype: torch.dtype) -> torch.Tensor:
    """Column indices ``(..., p)`` → one-hot selection matrices ``(..., m, p)``.

    ``A @ onehot`` selects columns exactly (one nonzero term per entry), and
    its backward is a matmul.  Gather and tensor indexing instead sum the
    gradient of repeated columns with atomics on CUDA, in an order that
    varies from run to run, which makes kernel-parameter training drift.
    """
    return torch.nn.functional.one_hot(cols, m).to(dtype).mT


def _selection(basis: GriefBasis, d: int) -> torch.Tensor:
    """``S_d = Q_d[:, idx_d] · λ_d[idx_d]^{-1/2}`` — the column selection and
    the normalization folded into one ``(m_d, p)`` operand."""
    Q, lam = basis.Qs[d], basis.lams[d]
    onehot = _onehot_cols(basis.idx[:, d], Q.shape[-1], Q.dtype)
    loglam = torch.log(torch.clamp(lam, min=torch.finfo(lam.dtype).tiny))
    return (Q @ onehot) * torch.exp(-0.5 * (loglam[None, :] @ onehot))


def _phi_fused_operands(basis: GriefBasis, Kx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked operands of K1: ``B_stack[d] = K_xU_d`` ``(d, n, m)`` and
    ``S_stack[d] = S_d`` ``(d, m, p)``."""
    B_stack = torch.stack(list(Kx), dim=0)
    S_stack = torch.stack([_selection(basis, d) for d in range(len(Kx))], dim=0)
    return B_stack, S_stack


def phi(
    basis: GriefBasis,
    kernels: Union[Stationary, KernList],
    xg: Sequence[torch.Tensor],
    x: torch.Tensor,
    *,
    dims: Optional[Sequence[Sequence[int]]] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Evaluate the ``(n, p)`` normalized eigenfunction features at ``x``.

    ``impl``:

    * ``"auto"``: K1 when ``x`` is a CUDA tensor and K1 applies (equal
      per-dimension grids, no dim grouping, d ≥ 2); otherwise the batched
      assembly when the dimensions stack; otherwise the per-dimension loop.
    * ``"fused"``: K1 (raises where it does not apply).  On CPU tensors its
      wrapper runs the plain version.
    * ``"batched"``: the batched einsum assembly (raises if inapplicable).
    * ``"xla"``: the per-dimension loop (the JAX package's name for it).

    All paths are differentiable.
    """
    if impl not in ("auto", "fused", "batched", "xla"):
        raise ValueError(f"unknown phi impl {impl!r}")
    applicable = _phi_fused_applicable(xg, dims)
    if impl == "fused" and not applicable:
        raise ValueError("phi(impl='fused') needs equal per-dim grids, d >= 2 and no dim grouping")
    use_fused = impl == "fused" or (impl == "auto" and applicable and x.is_cuda)
    stacked = stack_kernels(kernels, xg, dims) if impl in ("auto", "batched") and not use_fused else None
    if impl == "batched" and stacked is None:
        raise ValueError(
            "phi(impl='batched') needs equal per-dim grids, matching per-dim kernels, and no dim grouping"
        )
    rows = int(x.shape[0])
    _prof.count("phi_rows", rows)
    route = "batched" if stacked is not None else ("fused" if use_fused else "xla")
    with _phi_span(rows, int(basis.idx.shape[0]), route):
        if stacked is not None:
            return _phi_batched(basis, stacked, xg, x)
        Kx = cross_cov_grid(kernels, x, xg, dims)
        if use_fused:
            return phi_fused(*_phi_fused_operands(basis, Kx))
        out = None
        for d in range(len(xg)):
            G = Kx[d] @ _selection(basis, d)
            out = G if out is None else out * G
        return out


def _phi_batched(basis: GriefBasis, stacked: StackedKernel, xg, x: torch.Tensor) -> torch.Tensor:
    """Batched Φ assembly: one stacked cross-covariance, one einsum against
    the stacked selections ``S_d``, one product over d."""
    if x.ndim == 1:
        x = x[:, None]
    g_stack = torch.stack(list(xg))  # (d, m, s)
    Kx = stacked(x.T[:, :, None], g_stack)  # (d, n, m): dim d ↦ column d
    Q_stack = torch.stack(list(basis.Qs))  # (d, m, m)
    lam_stack = torch.stack(list(basis.lams))  # (d, m)
    tiny = torch.finfo(Kx.dtype).tiny
    loglam = torch.log(torch.clamp(lam_stack, min=tiny))
    onehot = _onehot_cols(basis.idx.T, Q_stack.shape[-1], Q_stack.dtype)  # (d, m, p)
    S = Q_stack @ onehot  # (d, m, p)
    scale = torch.exp(-0.5 * (loglam[:, None, :] @ onehot)[:, 0, :])  # (d, p)
    B = torch.einsum("dnm,dmp->dnp", Kx, S * scale[:, None, :])
    return torch.prod(B, dim=0)
