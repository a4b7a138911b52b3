"""Kronecker-product linear algebra on tuples of factor matrices.

Counterpart of ``gp_grief_tpu.ops.kron``.  A Kronecker matrix is a tuple of
per-dimension factors ``(K_1, ..., K_d)`` standing for ``K_1 ⊗ ... ⊗ K_d``.

Conventions, as in the JAX package:

* factor ``K_d`` has shape ``(q_d, m_d)``; the operator maps ``Π m_d → Π q_d``;
* vectors are flattened in C order over the dimension axes
  (``x.reshape(m_1, ..., m_d)``, ``i_1`` slowest);
* batched right-hand sides carry a trailing batch axis, ``v`` ``(M, B)``.

The matvec family here is the plain per-factor contraction chain
(``torch.tensordot``); the fast dispatch with the hand-written kernels is
``ops/kron_fast.py``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

Factors = Sequence[torch.Tensor]

__all__ = [
    "kron_shapes",
    "kron_matmat",
    "kron_matvec",
    "kron_expand",
    "kron_diag",
    "kron_eigh",
    "kron_svd",
    "kron_chol",
    "kron_logdet_from_chol",
    "kron_logdet_from_eigs",
    "kron_solve_schur",
]


def kron_shapes(factors: Factors) -> Tuple[int, int]:
    """Total (rows, cols) of ``K_1 ⊗ ... ⊗ K_d``."""
    rows = math.prod(int(f.shape[0]) for f in factors)
    cols = math.prod(int(f.shape[1]) for f in factors)
    return rows, cols


def kron_matmat(factors: Factors, v: torch.Tensor) -> torch.Tensor:
    """``(⊗_d K_d) @ v`` for ``v`` ``(M, B)``: reshape ``v`` onto the lattice
    ``(m_1, ..., m_d, B)`` and contract each factor along its own axis, in
    full precision.  Cost ``O(M · Σ_d q_d)``."""
    ms = [int(f.shape[1]) for f in factors]
    B = v.shape[-1]
    x = v.reshape(*ms, B)
    for d, K in enumerate(factors):
        x = torch.movedim(torch.tensordot(K, x, dims=([1], [d])), 0, d)
    return x.reshape(-1, B)


def kron_matvec(factors: Factors, v: torch.Tensor) -> torch.Tensor:
    """``(⊗_d K_d) @ v`` for ``v`` ``(M,)`` or ``(M, B)``."""
    if v.ndim == 1:
        return kron_matmat(factors, v[:, None])[:, 0]
    return kron_matmat(factors, v)


def kron_expand(factors: Factors) -> torch.Tensor:
    """Densify ``K_1 ⊗ ... ⊗ K_d``.  Test/small-scale oracle only."""
    out = factors[0]
    for K in factors[1:]:
        out = torch.kron(out, K)
    return out


def kron_diag(factors: Factors) -> torch.Tensor:
    """Diagonal of a square Kronecker product: ``⊗_d diag(K_d)`` flattened."""
    out = torch.diagonal(factors[0])
    for K in factors[1:]:
        out = (out[:, None] * torch.diagonal(K)[None, :]).reshape(-1)
    return out


def kron_eigh(factors: Factors) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-dimension symmetric eigendecomposition ``K_d = Q_d Λ_d Q_dᵀ``.

    Equal-size factors run as one batched ``eigh``; ragged sizes loop.
    Returns ``(Qs, lams)`` with ascending eigenvalues.
    """
    sizes = {int(f.shape[0]) for f in factors}
    if len(sizes) == 1 and len(factors) > 1:
        lams, Qs = torch.linalg.eigh(torch.stack(list(factors), dim=0))
        return tuple(Qs.unbind(0)), tuple(lams.unbind(0))
    out_Q, out_l = [], []
    for K in factors:
        lam, Q = torch.linalg.eigh(K)
        out_Q.append(Q)
        out_l.append(lam)
    return tuple(out_Q), tuple(out_l)


def kron_svd(
    factors: Factors,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-factor SVD ``K_d = U_d S_d V_dᵀ``, so ``⊗K_d = (⊗U_d)(⊗S_d)(⊗V_d)ᵀ``.

    Equal-shape factors run as one batched ``svd``; others loop.  Returns
    ``(Us, Ss, Vs)``: left singular vectors, singular values (descending) and
    right singular vectors ``V_d`` (not transposed).  Signs of the singular
    vectors are the linear-algebra library's."""
    shapes = {tuple(int(s) for s in f.shape) for f in factors}
    if len(shapes) == 1 and len(factors) > 1:
        U, S, Vh = torch.linalg.svd(torch.stack(list(factors), dim=0), full_matrices=False)
        return tuple(U.unbind(0)), tuple(S.unbind(0)), tuple(Vh.mT.unbind(0))
    Us, Ss, Vs = [], [], []
    for K in factors:
        U, S, Vh = torch.linalg.svd(K, full_matrices=False)
        Us.append(U)
        Ss.append(S)
        Vs.append(Vh.T)
    return tuple(Us), tuple(Ss), tuple(Vs)


def kron_chol(factors: Factors) -> Tuple[torch.Tensor, ...]:
    """Per-factor Cholesky: ``chol(⊗K_d) = ⊗chol(K_d)``; equal-size factors
    run as one batched ``cholesky``."""
    sizes = {int(f.shape[0]) for f in factors}
    if len(sizes) == 1 and len(factors) > 1:
        return tuple(torch.linalg.cholesky(torch.stack(list(factors), dim=0)).unbind(0))
    return tuple(torch.linalg.cholesky(K) for K in factors)


def kron_logdet_from_chol(chol_factors: Factors) -> torch.Tensor:
    """``log|⊗K_d|`` from per-factor Cholesky factors:
    ``Σ_d (m/m_d) · 2 Σ log diag(L_d)``."""
    m = math.prod(int(L.shape[0]) for L in chol_factors)
    total = torch.zeros((), dtype=chol_factors[0].dtype, device=chol_factors[0].device)
    for L in chol_factors:
        total = total + (m // int(L.shape[0])) * 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return total


def kron_logdet_from_eigs(lams: Factors) -> torch.Tensor:
    """``log|⊗K_d|`` from per-factor eigenvalues (PSD assumed):
    ``Σ_d (m/m_d) Σ log λ_d``."""
    m = math.prod(int(lam.shape[0]) for lam in lams)
    total = torch.zeros((), dtype=lams[0].dtype, device=lams[0].device)
    for lam in lams:
        total = total + (m // int(lam.shape[0])) * torch.sum(torch.log(lam))
    return total


def lam_kron(lams: Factors) -> torch.Tensor:
    """The flattened Kronecker eigenvalues ``⊗_d λ_d`` (C order)."""
    lam = lams[0]
    for other in lams[1:]:
        lam = (lam[:, None] * other[None, :]).reshape(-1)
    return lam


def kron_solve_schur(Qs: Factors, lams: Factors, b: torch.Tensor, shift=0.0) -> torch.Tensor:
    """Solve ``(⊗K_d + shift·I) x = b`` from per-dimension eigendecompositions:
    ``x = Q (Qᵀ b / (λ_⊗ + shift))`` with ``Q = ⊗Q_d`` applied by Kronecker
    matmats.  ``b``: ``(M,)`` or ``(M, B)``."""
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    z = kron_matmat(tuple(Q.T for Q in Qs), b)
    z = z / (lam_kron(lams) + shift)[:, None]
    x = kron_matmat(Qs, z)
    return x[:, 0] if squeeze else x
