"""Parity of the port's GRIEF basis pipeline against the JAX package.

float64 on the CPU, the same NumPy inputs through both.  Eigenvector signs
are arbitrary on both sides, so the basis is compared through sign-invariant
quantities, and Φ elementwise only after the JAX basis is carried across with
``convert.basis_from_jax``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gp_grief_tpu.kernels import grief as jgrief
from gp_grief_tpu.kernels import stationary as jst
from gp_grief_tpu.ops import kron as jkron
from gp_grief_tpu.ops.topk import top_p_kron_eigs as j_top_p
from gp_grief_tpu_torch.convert import basis_from_jax
from gp_grief_tpu_torch.kernels import grief as tgrief
from gp_grief_tpu_torch.kernels import stationary as tst
from gp_grief_tpu_torch.ops import kron as tkron
from gp_grief_tpu_torch.ops import solve as tsolve
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs as t_top_p

torch.set_num_threads(1)

TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def test_top_p_no_ties():
    rng = np.random.default_rng(0)
    lams = [rng.uniform(0.01, 3.0, m) for m in (7, 5, 9, 4)]
    lj, ij = j_top_p([_j(l) for l in lams], 60)
    lt, it = t_top_p([_t(l) for l in lams], 60)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_top_p_ties():
    """Equal per-dimension spectra tie exactly: the stable sort breaks ties
    lower index first, like lax.top_k."""
    lam = np.random.default_rng(1).uniform(0.01, 3.0, 6)
    lj, ij = j_top_p([_j(lam)] * 3, 40)
    lt, it = t_top_p([_t(lam)] * 3, 40)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    assert {tuple(r) for r in it.numpy()} == {tuple(r) for r in np.asarray(ij)}


def test_top_p_lattice_smaller_than_p():
    lams = [np.array([0.5, 2.0]), np.array([1.0, 0.1, 3.0])]
    lj, ij = j_top_p([_j(l) for l in lams], 9)
    lt, it = t_top_p([_t(l) for l in lams], 9)
    np.testing.assert_array_equal(np.isinf(lt.numpy()), np.isinf(np.asarray(lj)))
    fin = np.isfinite(np.asarray(lj))
    np.testing.assert_allclose(lt.numpy()[fin], np.asarray(lj)[fin], rtol=TOL)
    np.testing.assert_array_equal(it.numpy()[fin], np.asarray(ij)[fin])


def test_kron_expand_and_eigh():
    rng = np.random.default_rng(2)
    fs = []
    for m in (3, 4, 3):
        a = rng.standard_normal((m, m))
        fs.append(a @ a.T + m * np.eye(m))
    np.testing.assert_allclose(
        tkron.kron_expand([_t(f) for f in fs]).numpy(), np.asarray(jkron.kron_expand([_j(f) for f in fs])), rtol=TOL
    )
    for ragged in (False, True):
        use = fs[:2] if ragged else [fs[0], fs[2]]
        Qs, lams = tkron.kron_eigh([_t(f) for f in use])
        _, lj = jkron.kron_eigh([_j(f) for f in use])
        for Q, lam, lamj, f in zip(Qs, lams, lj, use):
            np.testing.assert_allclose(lam.numpy(), np.asarray(lamj), rtol=TOL)
            np.testing.assert_allclose((Q * lam) @ Q.T, f, rtol=1e-11, atol=1e-11)


def test_solve_helpers():
    from gp_grief_tpu.ops import solve as jsolve

    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, 6))
    A = a @ a.T + 0.5 * np.eye(6)
    b = rng.standard_normal((6, 2))
    L = tsolve.cholesky(_t(A))
    np.testing.assert_allclose(tsolve.solve_chol(L, _t(b)).numpy(), np.linalg.solve(A, b), rtol=1e-11)
    np.testing.assert_allclose(tsolve.solve_chol(L, _t(b[:, 0])).numpy(), np.linalg.solve(A, b[:, 0]), rtol=1e-11)
    np.testing.assert_allclose(float(tsolve.logdet_from_chol(L)), np.linalg.slogdet(A)[1], rtol=1e-12)
    assert torch.isnan(tsolve.cholesky(_t(-A))).all()  # failed factor → NaN, no exception
    # Rank-deficient: the jitter escalation picks the same rung as the JAX package.
    R = a[:, :3] @ a[:, :3].T
    Lt, jt = tsolve.stable_cholesky(_t(R))
    Lj, jj = jsolve.stable_cholesky(_j(R))
    assert float(jt) == float(jj) > 0
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-9, atol=1e-12)


def _setup(sizes, kinds, n=60, seed=4):
    rng = np.random.default_rng(seed)
    xg = [np.linspace(-1.0 - 0.1 * i, 1.0 + 0.05 * i, m)[:, None] for i, m in enumerate(sizes)]
    x = rng.uniform(-1, 1, (n, len(sizes)))
    jk = [jst.make_kernel(k, lengthscale=0.5 + 0.07 * i) for i, k in enumerate(kinds)]
    tk = [tst.make_kernel(k, lengthscale=0.5 + 0.07 * i) for i, k in enumerate(kinds)]
    return x, xg, jk, tk


@pytest.mark.parametrize(
    "sizes,kinds",
    [((6, 6, 6), ("rbf",) * 3), ((5, 7, 6), ("rbf", "matern32", "matern52"))],
    ids=["batched", "per_dim"],
)
def test_build_basis_sign_invariant(sizes, kinds):
    _, xg, jk, tk = _setup(sizes, kinds)
    jb = jgrief.build_basis(jk, [_j(g) for g in xg], 40, dim_noise_var=1e-8)
    tb = tgrief.build_basis(tk, [_t(g) for g in xg], 40, dim_noise_var=1e-8)
    np.testing.assert_allclose(tb.log_lam.detach().numpy(), np.asarray(jb.log_lam), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tb.idx.numpy(), np.asarray(jb.idx))
    for Q, lam, Qj, lamj in zip(tb.Qs, tb.lams, jb.Qs, jb.lams):
        Q, lam, Qj, lamj = Q.detach().numpy(), lam.detach().numpy(), np.asarray(Qj), np.asarray(lamj)
        np.testing.assert_allclose(lam, lamj, rtol=1e-11, atol=TOL)
        np.testing.assert_allclose((Q * lam) @ Q.T, (Qj * lamj) @ Qj.T, rtol=1e-11, atol=TOL)


def test_build_basis_clamps_p():
    _, xg, _, tk = _setup((3, 2), ("rbf", "rbf"))
    assert tgrief.build_basis(tk, [_t(g) for g in xg], 50).idx.shape == (6, 2)


@pytest.mark.parametrize("impl", ["auto", "batched", "xla", "fused"])
def test_phi_matches_jax(impl):
    x, xg, jk, tk = _setup((6, 6, 6), ("rbf",) * 3)
    jb = jgrief.build_basis(jk, [_j(g) for g in xg], 40, dim_noise_var=1e-8)
    ref = np.asarray(jgrief.phi(jb, jk, [_j(g) for g in xg], _j(x), impl="xla"))
    tb = basis_from_jax(jb.Qs, jb.lams, jb.log_lam, jb.idx)
    got = tgrief.phi(tb, tk, [_t(g) for g in xg], _t(x), impl=impl).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_phi_ragged_and_grouped_match_jax():
    x, xg, jk, tk = _setup((5, 7, 6), ("rbf", "matern32", "matern52"))
    jb = jgrief.build_basis(jk, [_j(g) for g in xg], 30)
    tb = basis_from_jax(jb.Qs, jb.lams, jb.log_lam, jb.idx)
    ref = np.asarray(jgrief.phi(jb, jk, [_j(g) for g in xg], _j(x)))
    got = tgrief.phi(tb, tk, [_t(g) for g in xg], _t(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    # Grouped dims (sub_dim 2 + 1): per-dimension loop on both sides.
    rng = np.random.default_rng(5)
    xg2 = [rng.uniform(-1, 1, (7, 2)), np.linspace(-1, 1, 5)[:, None]]
    dims = ((0, 2), (1,))
    jb2 = jgrief.build_basis(jk[:2], [_j(g) for g in xg2], 20)
    tb2 = basis_from_jax(jb2.Qs, jb2.lams, jb2.log_lam, jb2.idx)
    ref2 = np.asarray(jgrief.phi(jb2, jk[:2], [_j(g) for g in xg2], _j(x), dims=dims))
    got2 = tgrief.phi(tb2, tk[:2], [_t(g) for g in xg2], _t(x), dims=dims).detach().numpy()
    np.testing.assert_allclose(got2, ref2, rtol=TOL, atol=TOL)


def test_phi_impl_errors():
    x, xg, _, tk = _setup((5, 7, 6), ("rbf", "matern32", "matern52"))
    tb = tgrief.build_basis(tk, [_t(g) for g in xg], 20)
    with pytest.raises(ValueError, match="fused"):
        tgrief.phi(tb, tk, [_t(g) for g in xg], _t(x), impl="fused")
    with pytest.raises(ValueError, match="batched"):
        tgrief.phi(tb, tk, [_t(g) for g in xg], _t(x), impl="batched")
    with pytest.raises(ValueError, match="unknown phi impl"):
        tgrief.phi(tb, tk, [_t(g) for g in xg], _t(x), impl="pallas")


@pytest.mark.parametrize("impl", ["batched", "xla"])
def test_phi_gradient_matches_jax(impl):
    """d Σ(Φ ∘ W) / d(kernel hypers) through eigh, selection and the batched
    assembly or the per-dimension loop, against jax.grad."""
    import jax

    x, xg, jk, tk = _setup((6, 6, 6), ("rbf",) * 3)
    W = np.random.default_rng(6).standard_normal((60, 25))
    jxg = [_j(g) for g in xg]

    def jf(ks):
        b = jgrief.build_basis(ks, jxg, 25, dim_noise_var=1e-6)
        P = jgrief.phi(b, ks, jxg, _j(x), impl=impl)
        return jnp.sum(P * P * W)  # sign-invariant in the eigenvectors

    gj = jax.jit(jax.grad(jf))(jk)
    txg = [_t(g) for g in xg]
    b = tgrief.build_basis(tk, txg, 25, dim_noise_var=1e-6)
    P = tgrief.phi(b, tk, txg, _t(x), impl=impl)
    torch.sum(P * P * _t(W)).backward()
    for k, kj in zip(tk, gj):
        np.testing.assert_allclose(k.log_lengthscale.grad.numpy(), np.asarray(kj.log_lengthscale), rtol=1e-9)
        np.testing.assert_allclose(k.log_variance.grad.numpy(), np.asarray(kj.log_variance), rtol=1e-9, atol=1e-12)


def test_selection_is_exact_column_selection():
    """The one-hot product that selects eigenvector columns reproduces
    indexing bit for bit, repeated columns included, and its gradient is the
    per-column sum of the selected columns' gradients."""
    _, xg, _, tk = _setup((6, 6, 6), ("rbf",) * 3)
    b = tgrief.build_basis(tk, [_t(g) for g in xg], 40, dim_noise_var=1e-8)
    for d in range(3):
        cols = b.idx[:, d]
        assert len(set(cols.tolist())) < cols.numel()  # repeated columns
        expect = b.Qs[d][:, cols] * torch.exp(-0.5 * torch.log(b.lams[d])[cols])
        assert torch.equal(tgrief._selection(b, d), expect)
    Q = b.Qs[0].detach().clone().requires_grad_()
    basis = tgrief.GriefBasis(Qs=(Q,), lams=(b.lams[0].detach(),), log_lam=b.log_lam, idx=b.idx[:, :1])
    G = torch.as_tensor(np.random.default_rng(8).standard_normal((6, 40)))
    (tgrief._selection(basis, 0) * G).sum().backward()
    scale = torch.exp(-0.5 * torch.log(basis.lams[0]))[basis.idx[:, 0]]
    expect = torch.zeros_like(Q).index_add_(1, basis.idx[:, 0], G * scale)
    np.testing.assert_allclose(Q.grad.numpy(), expect.numpy(), rtol=1e-14, atol=1e-14)
