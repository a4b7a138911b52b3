"""Deflation preconditioners for the grid operator ``⊗K_d + σ²I``.

Counterpart of ``gp_grief_tpu.ops.precond`` (``kron_deflation_preconditioner``,
``kron_deflation_sqrt_ops``).  With ``A = QΛQᵀ + σ²I`` and ``Q_p`` the top-p
Kronecker eigencolumns, ``M = Q_p Λ_p Q_pᵀ + σ²I`` has closed-form spectral
functions

    f(M) = f(σ²)·I + Q_p (f(Λ_p + σ²) − f(σ²)) Q_pᵀ,

applied with two Kronecker matvecs (``⊗Q_dᵀ`` then ``⊗Q_d``, both through
:func:`~gp_grief_tpu_torch.ops.kron_fast.kron_matvec_fast` at full precision)
and a p-entry gather/scatter on the eigen-lattice; ``Q_p`` is never formed.
The low-rank preconditioner of SKI's data-space solver (an explicit skinny
basis ``U``; :func:`lowrank_spectral_factor`, :func:`lowrank_sqrt_ops`) is
here too, with :func:`check_whitening`, which holds its ``M^{-1/2}`` to
being SPD before a solver treats ``M^{-1/2} A M^{-1/2}`` as whitened.  The
exact GP's factor is the partial pivoted Cholesky (:func:`pivoted_cholesky`,
:func:`pivoted_cholesky_matfree`: ``K ≈ LLᵀ`` from ``rank`` kernel rows),
whose ``M = LLᵀ + σ²I`` whitens through :func:`lowrank_sqrt_ops_from_factor`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast
from gp_grief_tpu_torch.ops.solve import solve_chol, stable_cholesky
from gp_grief_tpu_torch.utils import profiling as _prof

__all__ = [
    "check_whitening", "gram64", "kron_deflation_preconditioner", "kron_deflation_sqrt_ops", "lowrank_preconditioner",
    "lowrank_spectral_factor", "lowrank_sqrt_ops", "lowrank_sqrt_ops_from_factor", "pivoted_cholesky",
    "pivoted_cholesky_matfree", "whitening_logdet",
]

_factor_span = _prof.site("gp_grief.precond.factor", "rows", "cols", "top_r")


def kron_deflation_preconditioner(
    Qs: Sequence[torch.Tensor],
    lams: Sequence[torch.Tensor],
    idx: torch.Tensor,
    sigma2,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``M_inv(v)`` of the rank-p deflation (``Qs``/``lams`` from ``kron_eigh``,
    ``idx`` ``(p, d)`` from ``top_p_kron_eigs``); ``v`` ``(m,)`` or ``(m, B)``."""
    M_inv, _, _ = kron_deflation_sqrt_ops(Qs, lams, idx, sigma2)
    return M_inv


def kron_deflation_sqrt_ops(
    Qs: Sequence[torch.Tensor],
    lams: Sequence[torch.Tensor],
    idx: torch.Tensor,
    sigma2,
    *,
    kmv: Callable = kron_matvec_fast,
    rows: Optional[Tuple[int, int]] = None,
):
    """``(M_inv, M_inv_sqrt, logdet_M)`` of the rank-p Kronecker deflation.
    ``M_inv_sqrt`` whitens the grid operator for CG
    (``yᵀA⁻¹y = (M⁻½y)ᵀ(M⁻½AM⁻½)⁻¹(M⁻½y)``).

    ``kmv(factors, v, precision=...)`` is the Kronecker matvec
    (``kron_matvec_fast``).  ``rows=(lo, n)`` makes the operators act on the
    lattice rows ``[lo, lo + n)`` only, with ``kmv`` mapping those rows to
    those rows: the model-parallel form, whose ``kmv`` is
    ``parallel.kron_matvec_sharded``."""
    Qs = tuple(Q.contiguous() for Q in Qs)
    # Kernel wrappers take contiguous operands only; Q.T is a strided view.
    QT = tuple(Q.T.contiguous() for Q in Qs)
    sizes = [int(Q.shape[0]) for Q in Qs]
    m = math.prod(sizes)
    p = int(idx.shape[0])
    lam_p = torch.ones((p,), dtype=Qs[0].dtype, device=Qs[0].device)
    for d in range(len(Qs)):
        lam_p = lam_p * lams[d][idx[:, d]]
    sigma2 = torch.as_tensor(sigma2, dtype=lam_p.dtype, device=lam_p.device)
    # Flat index of each selected eigenpair on the eigen-lattice (C order).
    strides = [math.prod(sizes[d + 1 :]) for d in range(len(sizes))]
    flat = torch.sum(idx * torch.as_tensor(strides, dtype=idx.dtype, device=idx.device)[None, :], dim=1)
    n_rows, sel = m, None
    if rows is not None:  # the selected pairs that fall in the window
        lo, n_rows = rows
        mine = (flat >= lo) & (flat < lo + n_rows)
        flat, sel = flat[mine] - lo, torch.nonzero(mine)[:, 0]

    def _apply(diag_fun):
        base = diag_fun(sigma2)
        coef = diag_fun(lam_p + sigma2) - base  # (p,)
        if sel is not None:
            coef = coef[sel]

        def op(v: torch.Tensor) -> torch.Tensor:
            squeeze = v.ndim == 1
            vv = v[:, None] if squeeze else v
            z = kmv(QT, vv, precision="highest")  # eigen basis
            u = torch.zeros((n_rows, vv.shape[1]), dtype=z.dtype, device=z.device)
            u[flat] = z[flat] * coef[:, None]
            out = base * vv + kmv(Qs, u, precision="highest")
            return out[:, 0] if squeeze else out

        return op

    logdet_M = torch.sum(torch.log(lam_p + sigma2)) + (m - p) * torch.log(sigma2)
    return _apply(lambda s: 1.0 / s), _apply(lambda s: 1.0 / torch.sqrt(s)), logdet_M


def lowrank_sqrt_ops(U: torch.Tensor, lam: torch.Tensor, sigma2, *, layout: str = "col"):
    """Closed-form ``(M_inv, M_inv_sqrt, logdet_M)`` of ``M = U diag(λ) Uᵀ +
    σ²I`` for ORTHONORMAL skinny ``U (n, r)``: every function of ``M`` acts
    as ``f(M) = f(σ²)·I + U (f(λ+σ²) − f(σ²)) Uᵀ``.  ``M_inv_sqrt`` whitens
    CG and SLQ (``log|A| = log|M| + log|M⁻½AM⁻½|``).  ``layout="bm"``: the
    operators map ``(B, n)`` rows instead of ``(n,)``/``(n, B)`` columns.
    The products run in full precision (TF32 off on the card)."""
    if layout not in ("col", "bm"):
        raise ValueError("layout must be 'col' or 'bm'")
    sigma2 = torch.as_tensor(sigma2, dtype=lam.dtype, device=lam.device)
    lam_shift = lam + sigma2

    def _apply(diag_fun):
        base = diag_fun(sigma2)
        delta = diag_fun(lam_shift) - base  # (r,)

        def op(v: torch.Tensor) -> torch.Tensor:
            if layout == "bm":
                return base * v + (v @ U * delta[None, :]) @ U.T
            squeeze = v.ndim == 1
            vv = v[:, None] if squeeze else v
            out = base * vv + U @ (delta[:, None] * (U.T @ vv))
            return out[:, 0] if squeeze else out

        return op

    n = U.shape[0]
    logdet_M = torch.sum(torch.log(lam_shift)) + (n - lam.shape[0]) * torch.log(sigma2)
    return _apply(lambda s: 1.0 / s), _apply(lambda s: 1.0 / torch.sqrt(s)), logdet_M


def gram64(U: torch.Tensor, *, chunk: int = 131072) -> torch.Tensor:
    """``UᵀU`` in float64, summed over row chunks of ``chunk``."""
    r = U.shape[1]
    G = torch.zeros((r, r), dtype=torch.float64, device=U.device)
    for s in range(0, U.shape[0], chunk):
        Uk = U[s : s + chunk].double()
        G += Uk.T @ Uk
    return G


def check_whitening(U: torch.Tensor, lam: torch.Tensor, sigma2, *, chunk: int = 131072,
                    gram: Optional[torch.Tensor] = None) -> float:
    """Raise unless :func:`lowrank_sqrt_ops`'s ``M^{-1/2}`` for ``U (n, r)``,
    ``lam`` (ascending, positive) and ``σ²`` is SPD as computed.

    That operator is ``b·I + U diag(d) Uᵀ`` with ``b = σ⁻¹`` and ``d_i =
    (λ_i + σ²)^{-1/2} − b < 0``, which is SPD for an orthonormal ``U``.  With
    ``UᵀU = I + E``, its least eigenvalue is at least ``c(1 + ‖E‖₂) − b‖E‖₂``,
    ``c = (λ_max + σ²)^{-1/2}``, so it stays SPD while ``‖E‖₂ < c / (b − c)``.
    ``E`` is formed in float64 (:func:`gram64` over row chunks of ``chunk``,
    or ``gram`` where given).  Returns ``‖E‖₂``."""
    r = U.shape[1]
    G = gram64(U, chunk=chunk) if gram is None else gram
    with _prof.host_read("precond.check_whitening"):
        defect = float(torch.linalg.matrix_norm(G - torch.eye(r, dtype=G.dtype, device=G.device), ord=2))
    s2 = float(sigma2)
    b, c = s2**-0.5, (float(lam[-1]) + s2) ** -0.5
    if not defect < c / (b - c):
        raise RuntimeError(
            f"the deflation factor is not orthonormal enough to whiten: ||U^T U - I||_2 = {defect:.3e}, "
            f"M^(-1/2) stays SPD only below {c / (b - c):.3e} (lam_max {float(lam[-1]):.3e}, sigma2 {s2:.3e})"
        )
    return defect


def whitening_logdet(gram: torch.Tensor, lam: torch.Tensor, sigma2, n: int) -> torch.Tensor:
    """``log|M|`` (float64, on the device) of the ``M`` whose ``M^{-1/2}``
    :func:`lowrank_sqrt_ops` applies, ``S = b·I + U diag(d) Uᵀ`` with ``b =
    σ⁻¹`` and ``d_i = (λ_i + σ²)^{-1/2} − b``, from ``gram = UᵀU``
    (:func:`gram64`): ``log|M| = −2 log|S| = n log σ² − 2 log det(I +
    b⁻¹ diag(d) UᵀU)``.

    For an orthonormal ``U`` it is :func:`lowrank_sqrt_ops`'s ``logdet_M``;
    for a ``U`` that is orthonormal only to working precision it is the
    log-det of the whitening the solver actually applies, which keeps
    ``log|A| = log|M| + log|M^{-1/2} A M^{-1/2}|`` exact.  The difference
    matters at scale: at n = 1.9M, r = 300 and float32 on an H100, a
    CholeskyQR2 factor with float32 Grams has ``UᵀU`` 1.2e-4 over the
    identity on its diagonal, and the orthonormal formula then misses
    ``log|M|`` by 6.6-8.9 (the iterative NLML of ``models.gp_grief`` by half
    that)."""
    s2 = torch.as_tensor(sigma2, dtype=torch.float64, device=gram.device)
    b = torch.rsqrt(s2)
    d = torch.rsqrt(lam.double() + s2) - b
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    return n * torch.log(s2) - 2.0 * torch.linalg.slogdet(eye + (d / b)[:, None] * gram)[1]


def lowrank_preconditioner(U: torch.Tensor, lam: torch.Tensor, sigma2) -> Callable[[torch.Tensor], torch.Tensor]:
    """Woodbury inverse of ``M = U diag(λ) Uᵀ + σ²I`` for skinny ``U (n, k)``
    and positive ``λ``: ``M⁻¹v = (v − U C⁻¹ Uᵀ v)/σ²`` with
    ``C = σ² diag(1/λ) + UᵀU``."""
    C = sigma2 * torch.diag(1.0 / lam) + U.T @ U
    L = torch.linalg.cholesky(C)

    def M_inv(v: torch.Tensor) -> torch.Tensor:
        squeeze = v.ndim == 1
        vv = v[:, None] if squeeze else v
        out = (vv - U @ solve_chol(L, U.T @ vv)) / sigma2
        return out[:, 0] if squeeze else out

    return M_inv


def lowrank_spectral_factor(F: torch.Tensor, *, weights: torch.Tensor | None = None, top_r: int | None = None):
    """Spectral form of ``F diag(w) Fᵀ`` robust in float32: ``(U, lam)`` with
    ORTHONORMAL ``U (n, r)`` and ``lam ≥ 0`` (ascending) such that
    ``F diag(w) Fᵀ = U diag(lam) Uᵀ``.

    ``F`` is orthonormalized first (CholeskyQR, twice: the CholeskyQR2
    pattern), then the r×r congruence ``LᵀWL`` is eigendecomposed, which only
    needs absolute ``eps·λ₁`` accuracy; a one-shot eigh of the weighted Gram
    loses positive-definiteness in float32 (the JAX package's measurement).
    ``top_r`` keeps the ``top_r`` largest eigenpairs (the trailing columns).

    The top-``top_r`` pairs of a float32 ``F`` come from the p × p problem
    in float64 instead: ``G = FᵀF`` summed in float64 over row chunks
    (:func:`gram64`), ``W^½ G W^½ = V S Vᵀ``, ``U = F·(W^½ V S^{-½})``.  A
    float32 product sums each entry's n terms in one running sum: at n =
    1.9M, p = 400 on an H100 (GP-GRIEF's Φ, the one caller that truncates)
    CholeskyQR2's ``U`` came out with ``UᵀU`` 1.2e-4 over the identity on
    its diagonal, which bent the whitened operator's deflated directions by
    percents, and this route's within 1.2e-7 of it, in 32 ms against 142.
    Its ``U`` is orthonormal only as far as ``F`` is well conditioned (its
    error grows as ``eps₃₂·κ(F)``: 8e-5 at κ(F) = 1e4 and n = 100k on a CPU, where CholeskyQR2's
    is 2e-6), so the full factors (``top_r`` None: pivoted Cholesky, SKI's
    deflation basis), whose columns can span such ranges, keep CholeskyQR2,
    as float64 does; a zero eigenvalue gives a zero column.
    """
    with _factor_span(int(F.shape[0]), int(F.shape[1]), -1 if top_r is None else int(top_r)):
        if top_r is not None and F.dtype == torch.float32:
            return _spectral_factor64(F, weights, top_r)
        Ut = F
        Ls = []
        for _ in range(2):
            L, _ = stable_cholesky(Ut.T @ Ut)
            Ut = torch.linalg.solve_triangular(L.T, Ut, upper=True, left=False)  # Ut ← Ut·L⁻ᵀ
            Ls.append(L)
        # F = Ut·(L2ᵀL1ᵀ)  ⇒  F W Fᵀ = Ut (L2ᵀL1ᵀ W L1L2) Utᵀ.
        mid = Ls[1].T @ Ls[0].T
        if weights is not None:
            mid = mid * torch.sqrt(weights)[None, :]
        s, V = torch.linalg.eigh(mid @ mid.T)
        lam = torch.clamp_min(s, 0.0)
        if top_r is not None:
            r = max(0, int(min(top_r, lam.shape[0])))
            k = lam.shape[0] - r
            V, lam = V[:, k:], lam[k:]
        return Ut @ V, lam


def _spectral_factor64(F: torch.Tensor, weights, top_r):
    """:func:`lowrank_spectral_factor` from the p × p problem in float64;
    an eigenvalue at or under zero gives a zero column."""
    sw = torch.ones(F.shape[1], dtype=torch.float64, device=F.device) if weights is None else torch.sqrt(
        weights.double())
    s, V = torch.linalg.eigh(sw[:, None] * gram64(F) * sw[None, :])
    k = s.shape[0] - max(0, int(min(top_r, s.shape[0])))
    s, V = s[k:], V[:, k:]
    lam = torch.clamp_min(s, 0.0)
    inv = torch.where(lam > 0, torch.rsqrt(torch.where(lam > 0, lam, torch.ones_like(lam))), torch.zeros_like(lam))
    return F @ (sw[:, None] * V * inv[None, :]).to(F.dtype), lam.to(F.dtype)


def lowrank_sqrt_ops_from_factor(F: torch.Tensor, sigma2, *, weights: torch.Tensor | None = None,
                                 layout: str = "col"):
    """:func:`lowrank_sqrt_ops` of ``M = F diag(w) Fᵀ + σ²I`` from a raw
    (non-orthonormal) skinny factor, through :func:`lowrank_spectral_factor`."""
    U, lam = lowrank_spectral_factor(F, weights=weights)
    return lowrank_sqrt_ops(U, lam, sigma2, layout=layout)


def pivoted_cholesky(K: torch.Tensor, rank: int) -> torch.Tensor:
    """Partial pivoted Cholesky of a dense SPD Gram: ``K ≈ L Lᵀ`` with ``L (n,
    rank)`` built greedily on the largest remaining diagonal (the
    GPyTorch preconditioner: ``M = LLᵀ + σ²I`` holds a smooth kernel's
    dominant spectrum in a few columns).  See :func:`pivoted_cholesky_matfree`."""
    return pivoted_cholesky_matfree(lambda piv: K.index_select(0, piv.reshape(1))[0], torch.diagonal(K), rank)


def pivoted_cholesky_matfree(row_fn: Callable[[torch.Tensor], torch.Tensor], diag: torch.Tensor,
                             rank: int) -> torch.Tensor:
    """:func:`pivoted_cholesky` from row access only, with no ``(n, n)`` Gram:
    ``row_fn(i) -> K[i, :]`` for a 0-d index tensor ``i`` (``K`` symmetric,
    so rows are columns) and ``diag = diag(K)``.

    ``rank`` steps, none reading the device from the host: an argmax (the
    first maximum, as ``jnp.argmax`` takes it: a stationary kernel's diagonal
    ties everywhere and step 0 picks index 0), one kernel row, a rank-1
    diagonal update.  ``L`` is written row by row into a ``(rank, n)``
    buffer; an exhausted diagonal (``rank`` past the numerical rank) gives a
    zero column.  Returns ``L (n, rank)``."""
    n = diag.shape[0]
    rank = int(min(rank, n))
    Lrows = torch.zeros((rank, n), dtype=diag.dtype, device=diag.device)
    d = diag
    for j in range(rank):
        piv = torch.argmax(d).reshape(1)
        # The Schur-complement column at the pivot, K[:, piv] − L L[piv, :]ᵀ,
        # in the diagonal's dtype whatever the kernel's.
        col = row_fn(piv[0]).to(diag.dtype) - Lrows[:j].T @ Lrows[:j].index_select(1, piv)[:, 0]
        dpiv = d.index_select(0, piv)[0]
        pos = dpiv > 0
        scale = torch.where(pos, torch.rsqrt(torch.where(pos, dpiv, torch.ones_like(dpiv))), torch.zeros_like(dpiv))
        lj = col * scale
        d = torch.clamp_min(d - lj * lj, 0.0)
        Lrows[j] = lj
    return Lrows.T
