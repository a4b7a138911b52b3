"""The ``extra`` kernels (rational quadratic, periodic, cosine, white,
constant, linear, sums and products) against the JAX package's, float64 on
the CPU, on the same NumPy inputs.

Each kernel's Gram (on one input set and across two), its ``cov_diag`` and
the gradient of a weighted Gram sum are the same arithmetic in both
packages: 1e-12 relative.  A composite kernel through ``GPRegression``:
the Cholesky NLML, gradient and predictions at 1e-10 (as
``test_torch_gp_regression.py``), and the iterative NLML and gradient with
the same NumPy probes, CG to 1e-12, at 1e-9.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
import gp_grief_tpu_torch.ops.lanczos as tlz
import jax
import jax.numpy as jnp
from gp_grief_tpu.kernels import diag as jdiag
from gp_grief_tpu.kernels import extra as jx
from gp_grief_tpu_torch.convert import params_from_jax
from gp_grief_tpu_torch.kernels.diag import cov_diag
from jax.flatten_util import ravel_pytree
from tools import ski_reference_jax as ref

torch.set_num_threads(1)

TOL = 1e-12


def _both(build):
    """``build(pkg, log)`` with ``log`` the package's ``log`` of a float64
    value: the JAX kernel and the port's."""
    return build(jx, lambda v: jnp.log(jnp.asarray(v, dtype=jnp.float64))), build(
        gpt, lambda v: torch.log(torch.as_tensor(v, dtype=torch.float64)))


KERNELS = {
    "ratquad": lambda p, log: p.make_ratquad(lengthscale=0.7, variance=1.3, alpha=2.5, input_dim=2),
    "periodic": lambda p, log: p.make_periodic(lengthscale=0.9, variance=0.8, period=1.7),
    "cosine": lambda p, log: p.Cosine(log_variance=log(1.2), log_period=log(2.3)),
    "white": lambda p, log: p.White(log_variance=log(0.4)),
    "constant": lambda p, log: p.Constant(log_variance=log(0.6)),
    "linear": lambda p, log: p.Linear(log_variances=log([0.5, 1.5])),
    "sum": lambda p, log: p.Sum(p.make_ratquad(lengthscale=0.8, variance=1.1, alpha=1.5),
                                p.White(log_variance=log(0.2))),
    "product": lambda p, log: p.Product(p.make_periodic(lengthscale=1.1, variance=1.0, period=2.0),
                                        p.Linear(log_variances=log(0.7))),
    "nested": lambda p, log: p.Sum(p.Product(p.Constant(log_variance=log(0.9)), p.Cosine(log_variance=log(1.1),
                                                                                         log_period=log(1.3))),
                                   p.Sum(p.make_periodic(period=2.5), p.make_ratquad(alpha=0.8))),
}


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (40, 2))
    z = np.concatenate([rng.uniform(-2, 2, (25, 2)), x[:5]])  # coincident pairs for White
    return x, z, rng.standard_normal((40, 40)), rng.standard_normal((40, 30))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", list(KERNELS))
def test_gram_diag_and_gradient_match_jax(name):
    jk, tk = _both(KERNELS[name])
    x, z, W1, W2 = _inputs()
    jxx, jzz = jnp.asarray(x), jnp.asarray(z)
    tx, tz = torch.as_tensor(x), torch.as_tensor(z)
    _close(tk(tx).detach().numpy(), np.asarray(jk(jxx)))
    _close(tk(tx, tz).detach().numpy(), np.asarray(jk(jxx, jzz)))
    _close(cov_diag(tk, tx).detach().numpy(), np.asarray(jdiag.cov_diag(jk, jxx)))

    def jloss(k):
        return jnp.sum(k(jxx) * W1) + jnp.sum(k(jxx, jzz) * W2)

    want = np.asarray(ravel_pytree(jax.grad(jloss)(jk))[0])
    loss = torch.sum(tk(tx) * torch.as_tensor(W1)) + torch.sum(tk(tx, tz) * torch.as_tensor(W2))
    # In registration order, which is the JAX dataclass's field order.
    got = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, list(tk.parameters()))]).numpy()
    _close(got, want)


def test_cov_diag_falls_back_to_vmap_for_other_modules():
    class Scaled(torch.nn.Module):  # a user's kernel: cov_diag knows nothing of it
        def __init__(self):
            super().__init__()
            self.inner = gpt.make_periodic(variance=1.7)

        def forward(self, x, z=None):
            return 2.0 * self.inner(x, z)

    x = torch.as_tensor(_inputs()[0])
    k = Scaled()
    _close(cov_diag(k, x).detach().numpy(), torch.diagonal(k(x)).detach().numpy())
    with pytest.raises(NotImplementedError, match="dict"):
        cov_diag({}, x)


def _pair(kernel_name, **kw):
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (120, 2))
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.standard_normal(120)
    jk, tk = _both(KERNELS[kernel_name])
    jm = gpx.GPRegression(x, y, jk, noise_var=0.2, **kw)
    tm = gpt.GPRegression(x, y, tk, noise_var=0.2, device="cpu", **kw)
    return jm, tm, rng.uniform(-2, 2, (15, 2))


def _value_and_grads(jm, tm):
    vj, gj = jax.value_and_grad(jm._loss)(jm.params)
    tm.zero_grad()
    vt = tm._loss()
    vt.backward()
    gt = np.concatenate([p.grad.reshape(-1).numpy() for _, p in tm._leaves()])
    return float(vt.detach()), gt, float(vj), np.asarray(ravel_pytree(gj)[0])


@pytest.mark.parametrize("name", ["nested", "product"])
def test_composite_kernel_through_cholesky_gp(name):
    jm, tm, xs = _pair(name)
    assert tm._param_leaf_names() == jm._param_leaf_names()
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    vt, gt, vj, gj = _value_and_grads(jm, tm)
    assert vt == pytest.approx(vj, rel=1e-10)
    _close(gt, gj, 1e-10)
    mj, vj = jm.predict(xs)
    mt, vt = tm.predict(xs)
    _close(mt.numpy(), mj, 1e-10)
    _close(vt.numpy(), vj, 1e-10)


@pytest.mark.parametrize("chunk", [0, 48], ids=["dense", "matfree"])
def test_composite_kernel_through_iterative_gp(monkeypatch, chunk):
    monkeypatch.setattr(jax.random, "rademacher", ref.NumpyProbes())
    monkeypatch.setattr(tlz, "rademacher", cs.NumpyProbes())
    jm, tm, _ = _pair("sum", solver="iterative", matvec_chunk=chunk, precond_rank=8, num_probes=4,
                      lanczos_iters=10, cg_tol=1e-12, cg_iters=400)
    vt, gt, vj, gj = _value_and_grads(jm, tm)
    assert vt == pytest.approx(vj, rel=1e-9)
    _close(gt, gj, 1e-9)


def test_params_from_jax_on_nested_leaves():
    jm, tm, _ = _pair("nested")
    jm.optimize(optimizer="adam", max_iters=3)
    leaves = dict(zip(jm._param_leaf_names(), [np.asarray(v) for v in jax.tree_util.tree_leaves(jm.params)]))
    assert "kernel.k1.k2.log_period" in leaves and "kernel.k2.k2.log_alpha" in leaves
    tm.load_state_dict(params_from_jax(leaves))
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    assert tm.log_likelihood() == pytest.approx(jm.log_likelihood(), rel=1e-10)
    with pytest.raises(KeyError):
        params_from_jax({"kernel.k3.log_period": np.zeros(())})
