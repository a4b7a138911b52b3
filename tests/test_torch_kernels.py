"""Parity of the PyTorch port's kernels and grid against the JAX package.

Same NumPy inputs through both packages in float64 on the CPU.  Tolerance
1e-12: both sides evaluate the same formulas in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gp_grief_tpu.grid import InducingGrid as JGrid
from gp_grief_tpu.kernels import grid as jgrid
from gp_grief_tpu.kernels import stationary as jst
from gp_grief_tpu_torch.grid import InducingGrid as TGrid
from gp_grief_tpu_torch.kernels import base as tbase
from gp_grief_tpu_torch.kernels import grid as tgrid
from gp_grief_tpu_torch.kernels import stationary as tst

torch.set_num_threads(1)

TOL = 1e-12


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("kind", jst.KERNEL_KINDS)
@pytest.mark.parametrize("regime,d", [("broadcast", 3), ("matmul", 6)])
def test_cov_matches_jax(kind, regime, d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, d))
    z = rng.standard_normal((30, d))
    assert tst._use_broadcast_dist(40, 30, d) == (regime == "broadcast")
    ls = rng.uniform(0.5, 2.0, d)
    jk = jst.make_kernel(kind, lengthscale=ls, variance=1.3)
    tk = tst.make_kernel(kind, lengthscale=ls, variance=1.3)
    for a, b in [(x, None), (x, z)]:
        ref = np.asarray(jk(_j(a), _j(b)))
        got = tk(_t(a), _t(b)).detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", jst.KERNEL_KINDS)
def test_cov_gradient_matches_jax(kind):
    """Hyperparameter gradients, through the Matérn zero-distance guard."""
    import jax

    rng = np.random.default_rng(2)
    x = rng.standard_normal((25, 2))
    x[3] = x[7]  # a coincident pair off the diagonal
    W = rng.standard_normal((25, 25))
    jk = jst.make_kernel(kind, lengthscale=[0.8, 1.4], variance=0.9)
    tk = tst.make_kernel(kind, lengthscale=[0.8, 1.4], variance=0.9)
    gj = jax.grad(lambda k: jnp.sum(k(jnp.asarray(x)) * W))(jk)
    torch.sum(tk(_t(x)) * _t(W)).backward()
    np.testing.assert_allclose(tk.log_lengthscale.grad.numpy(), np.asarray(gj.log_lengthscale), rtol=1e-10)
    np.testing.assert_allclose(tk.log_variance.grad.numpy(), np.asarray(gj.log_variance), rtol=1e-10)


@pytest.mark.parametrize("kind", ["matern12", "matern32", "matern52"])
def test_self_pair_zero_snap(kind):
    """Matmul regime with z a copy of x (so not the ``same`` path): the
    cancellation residue must snap to exact zero, giving k(x, x) = σ²."""
    rng = np.random.default_rng(3)
    x = 10.0 + rng.standard_normal((50, 6))  # offset: large ‖x‖² cancellation
    tk = tst.make_kernel(kind, lengthscale=0.7, variance=1.7)
    K = tk(_t(x), _t(x.copy())).detach().numpy()
    np.testing.assert_allclose(np.diag(K), 1.7, rtol=0, atol=TOL)
    ref = np.asarray(jst.make_kernel(kind, lengthscale=0.7, variance=1.7)(_j(x), _j(x.copy())))
    np.testing.assert_allclose(K, ref, rtol=TOL, atol=TOL)


def test_make_kernel_aliases_and_errors():
    for alias, kind in [("sqexp", "rbf"), ("Mat-32", "matern32"), ("ou", "matern12"), ("exponential", "exponential")]:
        assert tst.make_kernel(alias).kind == jst.make_kernel(alias).kind == kind
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tst.make_kernel("typo")
    k = tst.make_kernel("rbf", lengthscale=0.5, input_dim=3, dtype=torch.float32)
    assert k.log_lengthscale.shape == (3,) and k.log_lengthscale.dtype == torch.float32
    assert [n for n, _ in k.named_parameters()] == ["log_lengthscale", "log_variance"]


def test_positive_transforms():
    v = np.array([1e-3, 0.5, 2.0, 7.0])
    np.testing.assert_allclose(tbase.inverse_positive(v).numpy(), np.log(v), rtol=0, atol=0)
    np.testing.assert_allclose(tbase.positive(tbase.inverse_positive(v)).numpy(), v, rtol=1e-15)


def _grid_and_kernels(sizes, kinds):
    rng = np.random.default_rng(4)
    xg = [np.sort(rng.uniform(-1, 1, (m, 1)), axis=0) for m in sizes]
    jk = [jst.make_kernel(k, lengthscale=0.4 + 0.1 * i) for i, k in enumerate(kinds)]
    tk = [tst.make_kernel(k, lengthscale=0.4 + 0.1 * i) for i, k in enumerate(kinds)]
    return rng, xg, jk, tk


@pytest.mark.parametrize("shared", [False, True])
def test_cov_grid_and_cross_cov_grid(shared):
    rng, xg, jk, tk = _grid_and_kernels([5, 7, 6], ["rbf", "matern32", "matern52"])
    if shared:
        jk, tk = jk[0], tk[0]
    x = rng.uniform(-1, 1, (33, 3))
    for a, b in zip(tgrid.cov_grid(tk, [_t(g) for g in xg], dim_noise_var=1e-6),
                    jgrid.cov_grid(jk, [_j(g) for g in xg], dim_noise_var=1e-6)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    for a, b in zip(tgrid.cross_cov_grid(tk, _t(x), [_t(g) for g in xg]),
                    jgrid.cross_cov_grid(jk, _j(x), [_j(g) for g in xg])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tgrid.product_cov(tk, _t(x)).detach().numpy(), np.asarray(jgrid.product_cov(jk, _j(x))),
        rtol=TOL, atol=TOL,
    )


def test_cross_cov_grid_grouped_dims():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (40, 3))
    dims = ((0, 2), (1,))
    jg = JGrid.build(x, mbar=6, dims=dims)
    tg = TGrid.build(x, mbar=6, dims=dims)
    jk = [jst.make_kernel("rbf", lengthscale=0.5), jst.make_kernel("matern52", lengthscale=0.6)]
    tk = [tst.make_kernel("rbf", lengthscale=0.5), tst.make_kernel("matern52", lengthscale=0.6)]
    for a, b in zip(tgrid.cross_cov_grid(tk, _t(x), [_t(g) for g in tg.xg], dims),
                    jgrid.cross_cov_grid(jk, _j(x), [_j(g) for g in jg.xg], dims)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "kwargs",
    [dict(mbar=8), dict(mbar=[5, 9, 4]), dict(mbar=7, eq=False), dict(mbar=6, dims=((0, 2), (1,)))],
)
def test_inducing_grid_identical(kwargs):
    rng = np.random.default_rng(6)
    x = rng.uniform(-2, 3, (200, 3))
    x[:, 1] = np.round(x[:, 1])  # few unique values: kept verbatim
    jg, tg = JGrid.build(x, **kwargs), TGrid.build(x, **kwargs)
    assert tg.grid_shape == jg.grid_shape and tg.dims == jg.dims
    assert tg.input_dim == jg.input_dim and tg.num_data == jg.num_data
    for a, b in zip(tg.xg, jg.xg):
        np.testing.assert_array_equal(a, b)
    assert tg.log10_num_virtual == jg.log10_num_virtual
