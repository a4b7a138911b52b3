"""Parity of the port's structured-ops surface against the JAX package's, in
float64 on the CPU: the Kronecker SVD / Cholesky / log-det
(tests/test_kron.py:70), the Khatri-Rao and row/col-selected products
(tests/test_khatri_rao.py:33-64), selection with repeated indices (:67),
operator composition, and the ``ops`` namespace against
``gp_grief_tpu.ops.__all__``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gp_grief_tpu.ops as jops
import gp_grief_tpu_torch.ops as tops

torch.set_num_threads(1)

# gp_grief_tpu.ops names the port does not export, each recorded in ROADMAP.md
# ("Not ported"): the TPU's batch padding, its one-hot Wᵀ operand layout, the
# per-program segmented drivers; and ``lanczos``, which stays the module.
DEPARTURES = {
    "safe_batch_op", "OneHotPlan", "build_onehot_plan", "make_onehot_rmatvec", "cg_solve_segmented",
    "cg_solve_refined_segmented", "slq_logdet_segmented", "lanczos",
}


def _spd_factors(rng, sizes):
    out = []
    for m in sizes:
        A = rng.standard_normal((m, m))
        out.append(A @ A.T + m * np.eye(m))
    return out


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_ops_namespace_matches_jax():
    """Every public name of the JAX package's ``ops`` exists in the port's
    under the same name, less the recorded departures."""
    missing = sorted(set(jops.__all__) - DEPARTURES - set(tops.__all__))
    assert missing == []
    assert not (DEPARTURES - {"lanczos"}) & set(tops.__all__)
    for name in tops.__all__:
        assert getattr(tops, name) is not None
    assert tops.lanczos.__name__ == "gp_grief_tpu_torch.ops.lanczos"


@pytest.mark.parametrize("sizes", [(3, 4), (4, 4, 4)], ids=["ragged", "equal"])
def test_kron_chol_and_logdet_match_jax(sizes):
    rng = np.random.default_rng(0)
    factors = _spd_factors(rng, sizes)
    Lt = tops.kron_chol([_t(K) for K in factors])
    Lj = jops.kron_chol([jnp.asarray(K) for K in factors])
    for a, b in zip(Lt, Lj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    K = np.asarray(tops.kron_expand([_t(F) for F in factors]))
    L = tops.kron_expand(list(Lt)).numpy()
    np.testing.assert_allclose(L @ L.T, K, rtol=1e-9)
    _, ref = np.linalg.slogdet(K)
    got = float(tops.kron_logdet_from_chol(Lt))
    assert got == pytest.approx(float(jops.kron_logdet_from_chol(Lj)), rel=1e-12)
    assert got == pytest.approx(ref, rel=1e-10)


@pytest.mark.parametrize("sizes", [((3, 5), (4, 2)), ((4, 4), (4, 4), (4, 4))], ids=["ragged", "equal"])
def test_kron_svd_matches_jax(sizes):
    """Singular values against JAX's, descending; reconstructions; ``|U|``
    and ``|V|`` (signs are LAPACK's)."""
    rng = np.random.default_rng(1)
    factors = [rng.standard_normal(s) for s in sizes]
    Ut, St, Vt = tops.kron_svd([_t(K) for K in factors])
    Uj, Sj, Vj = jops.kron_svd([jnp.asarray(K) for K in factors])
    for K, u, s, v, uj, sj, vj in zip(factors, Ut, St, Vt, Uj, Sj, Vj):
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-12)
        assert np.all(np.diff(s.numpy()) <= 0)
        np.testing.assert_allclose((u * s) @ v.T, K, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.abs(u.numpy()), np.abs(np.asarray(uj)), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.abs(v.numpy()), np.abs(np.asarray(vj)), rtol=1e-9, atol=1e-12)
        assert v.shape == (K.shape[1], min(K.shape))


@pytest.mark.parametrize("sizes", [(4,), (3, 5), (2, 3, 4)])
def test_kr_rmatvec_matches_jax(sizes):
    rng = np.random.default_rng(2)
    n = 6
    A = [rng.standard_normal((n, m)) for m in sizes]
    KR = tops.kr_expand([_t(a) for a in A]).numpy()
    for u in (rng.standard_normal(n), rng.standard_normal((n, 2))):
        got = tops.kr_rmatvec([_t(a) for a in A], _t(u)).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.kr_rmatvec([jnp.asarray(a) for a in A], jnp.asarray(u))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, KR.T @ u, rtol=1e-10)


def test_rowcol_kr_ops_match_jax():
    rng = np.random.default_rng(3)
    n, p, sizes = 7, 5, (3, 4, 2)
    B = [rng.standard_normal((n, m)) for m in sizes]
    idx = np.stack([rng.integers(0, m, size=p) for m in sizes], axis=1).astype(np.int32)
    Bt, Bj = [_t(b) for b in B], [jnp.asarray(b) for b in B]
    Phi = tops.rowcol_kr_expand(Bt, _t(idx)).numpy()
    ref = np.ones((n, p))
    for d, b in enumerate(B):
        ref *= b[:, idx[:, d]]
    np.testing.assert_array_equal(Phi, np.asarray(jops.rowcol_kr_expand(Bj, jnp.asarray(idx))))
    np.testing.assert_allclose(Phi, ref, rtol=1e-12)
    for v in (rng.standard_normal(p), rng.standard_normal((p, 3))):
        got = tops.rowcol_kr_matvec(Bt, _t(idx), _t(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.rowcol_kr_matvec(Bj, jnp.asarray(idx), jnp.asarray(v))),
                                   rtol=1e-12)
        np.testing.assert_allclose(got, ref @ v, rtol=1e-10)
    for u in (rng.standard_normal(n), rng.standard_normal((n, 2))):
        got = tops.rowcol_kr_rmatvec(Bt, _t(idx), _t(u)).numpy()
        np.testing.assert_allclose(got, np.asarray(jops.rowcol_kr_rmatvec(Bj, jnp.asarray(idx), jnp.asarray(u))),
                                   rtol=1e-12)
        np.testing.assert_allclose(got, ref.T @ u, rtol=1e-10)


@pytest.mark.parametrize("idx", [[5, 0, 2], [5, 0, 2, 5, 5, 0, 7, 2]], ids=["distinct", "repeated"])
def test_selection_ops_match_jax(idx):
    rng = np.random.default_rng(4)
    m = 8
    x = rng.standard_normal((m, 4))
    u = rng.standard_normal((len(idx), 4))
    S = tops.selection_expand(_t(idx), m).numpy()
    np.testing.assert_array_equal(S, np.asarray(jops.selection_expand(jnp.asarray(idx), m)))
    got = tops.select_rows(_t(idx), _t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.select_rows(jnp.asarray(idx), jnp.asarray(x))))
    np.testing.assert_array_equal(got, S @ x)
    got_t = tops.select_rows_t(_t(idx), _t(u), m)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(jops.select_rows_t(jnp.asarray(idx), jnp.asarray(u), m)),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(got_t.numpy(), S.T @ u, rtol=1e-12, atol=1e-15)
    # One-column and empty inputs keep their shapes.
    assert tops.select_rows_t(_t(idx), _t(u[:, 0]), m).shape == (m,)
    assert torch.equal(tops.select_rows_t(_t(idx[:0]), _t(u[:0]), m), torch.zeros((m, 4), dtype=torch.float64))


def test_select_rows_t_sums_each_run_in_index_order():
    """Repeated indices sum in the order they appear, as a sequential loop
    does, so two calls give the same bits."""
    rng = np.random.default_rng(5)
    k, m = 4000, 37
    idx = torch.as_tensor(rng.integers(0, m, size=k))
    u = torch.as_tensor(rng.standard_normal((k, 3)).astype(np.float32))
    want = torch.zeros((m, 3), dtype=torch.float32)
    for i in range(k):
        want[idx[i]] += u[i]
    got = tops.select_rows_t(idx, u, m)
    assert torch.equal(got, want) and torch.equal(tops.select_rows_t(idx, u, m), got)


def test_compose_ops():
    rng = np.random.default_rng(6)
    A, B = _t(rng.standard_normal((5, 5))), _t(rng.standard_normal((5, 5)))
    v = _t(rng.standard_normal(5))
    a, b = (lambda x: A @ x), (lambda x: B @ x)
    torch.testing.assert_close(tops.op_product([a, b])(v), A @ (B @ v), rtol=0, atol=0)
    torch.testing.assert_close(tops.op_sum([a, b, a])(v), (A @ v + B @ v) + A @ v, rtol=0, atol=0)
    torch.testing.assert_close(tops.op_scale(a, 2.5)(v), 2.5 * (A @ v), rtol=0, atol=0)
    torch.testing.assert_close(tops.op_shift(a, 0.3)(v), A @ v + 0.3 * v, rtol=0, atol=0)
    jv = jnp.asarray(v.numpy())
    ja, jb = (lambda x: jnp.asarray(A.numpy()) @ x), (lambda x: jnp.asarray(B.numpy()) @ x)
    composed_t = tops.op_shift(tops.op_scale(tops.op_product([a, tops.op_sum([a, b])]), 0.5), 2.0)(v)
    composed_j = jops.op_shift(jops.op_scale(jops.op_product([ja, jops.op_sum([ja, jb])]), 0.5), 2.0)(jv)
    np.testing.assert_allclose(composed_t.numpy(), np.asarray(composed_j), rtol=1e-13)


# gp_grief_tpu.parallel names the port does not export, each recorded in
# ROADMAP.md: jax.sharding's partition spec and sharding (no torch meaning)
# and the windowed plans' builder.
PARALLEL_DEPARTURES = {"P", "NamedSharding", "build_sharded_windowed_interp"}


def test_parallel_namespace_matches_jax():
    import gp_grief_tpu.parallel as jpar
    import gp_grief_tpu_torch.parallel as tpar

    assert sorted(set(jpar.__all__) - PARALLEL_DEPARTURES) == sorted(tpar.__all__)
    for name in tpar.__all__:
        assert getattr(tpar, name) is not None


def test_build_sharded_interp_splits_the_padded_rows():
    """Each block's plan is the plan of its rows: the blocks' Wᵀ sum to the
    whole padded set's, as the JAX package's stacked plans do."""
    import gp_grief_tpu_torch.parallel as tpar
    from gp_grief_tpu_torch.ops.interp import build_interp_plan, interp_weights
    from gp_grief_tpu_torch.ops.cuda.interp import interp_wt

    rng = np.random.default_rng(6)
    x = rng.uniform(0, 2, (101, 2))
    xg = [np.linspace(-0.1, 2.1, 7)] * 2
    xp, _ = tpar.pad_to_multiple(x, 4)
    plans = tpar.build_sharded_interp(xp, xg, 4)
    u = torch.as_tensor(rng.standard_normal((3, xp.shape[0])))
    whole = interp_wt(build_interp_plan(interp_weights(xp, xg)), u)
    parts = sum(interp_wt(pl, u[:, k * 26 : (k + 1) * 26]) for k, pl in enumerate(plans))
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)
    one = tpar.build_sharded_interp(xp, xg, 4, rank=2)
    np.testing.assert_array_equal(interp_wt(one, u[:, 52:78]).numpy(), interp_wt(plans[2], u[:, 52:78]).numpy())


@pytest.mark.parametrize("kind", ["grief", "ski"])
def test_params_from_jax_carries_the_sharded_models(kind):
    """The JAX package's sharded models' leaves load into the port's sharded
    models (a one-rank mesh here) under the single-device leaf names, and
    both compute the same NLML.  SKI takes full-rank deflation (r = M), which
    makes its whitened SLQ term exactly zero, so its NLML is the same
    whatever the probes."""
    import jax

    import gp_grief_tpu as gpx
    import gp_grief_tpu.parallel as jpar
    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch.convert import params_from_jax

    rng = np.random.default_rng(4)
    mesh = jpar.make_mesh((2,), ("data",), devices=jax.devices()[:2])
    if kind == "grief":
        x = rng.uniform(0, 1, (90, 2))
        y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(90)
        grid = gpx.InducingGrid.build(x, mbar=6)
        kw = dict(n_eigs=10, noise_var=0.2, dim_noise_var=1e-12)
        jm = jpar.ShardedGPGriefModel(x, y, [gpx.make_kernel("rbf", lengthscale=0.5)] * 2, grid, mesh=mesh, **kw)
        jm.optimize(optimizer="adam", max_iters=3, learning_rate=0.05)
        tm = gpt.parallel.ShardedGPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.5)] * 2,
                                              gpt.InducingGrid.build(x, mbar=6), device="cpu", **kw)
        tol = 1e-10
    else:
        x = rng.uniform(0, 2, (96, 2))
        y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(96)
        xg = [np.linspace(-0.1, 2.1, 6)[:, None]] * 2
        kw = dict(noise_var=0.3, num_probes=4, lanczos_iters=10, cg_iters=200, cg_tol=1e-10, precond_rank=36)
        jm = jpar.ShardedGPSKIRegression(x, y, gpx.make_kernel("rbf", lengthscale=0.6), xg, mesh=mesh, **kw)
        jm.params = {**jm.params, "log_noise": jm.params["log_noise"] - 0.4}
        tm = gpt.parallel.ShardedGPSKIRegression(x, y, gpt.make_kernel("rbf", lengthscale=0.6), xg, device="cpu",
                                                 **kw)
        tol = 1e-8
    leaves = dict(zip(jm._param_leaf_names(), [np.asarray(v) for v in jax.tree_util.tree_leaves(jm.params)]))
    assert sorted(leaves) == sorted(tm.state_dict())
    tm.load_state_dict(params_from_jax(leaves))
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=tol)
