"""The port's Lanczos, SLQ and low-rank preconditioner (ops/lanczos.py,
ops/precond.py) against the JAX package's, float64 on the CPU.

Both SLQ estimators are handed the same NumPy Rademacher probes (the JAX
side through ``jax.random.rademacher``, the port through its one draw
function ``ops.lanczos.rademacher``).  Tolerance 1e-10: the recurrences
round in different orders, and Lanczos without reorthogonalization amplifies
that over its steps."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gp_grief_tpu.ops import precond as jpre
from gp_grief_tpu_torch.ops import lanczos as tlz
from gp_grief_tpu_torch.ops import precond as tpre

# The JAX package's ops namespace exports the function ``lanczos``; the module:
jlz = importlib.import_module("gp_grief_tpu.ops.lanczos")

torch.set_num_threads(1)

TOL = 1e-10


def _spd(m, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    return (Q * np.geomspace(0.5, 50.0, m)) @ Q.T


class _Probes:
    """NumPy Rademacher probes in call order, for either package."""

    def __init__(self, seed, torch_side):
        self.rng, self.torch_side = np.random.default_rng(seed), torch_side

    def __call__(self, *args, **kw):
        shape = kw["shape"] if "shape" in kw else (args[0] if self.torch_side else args[1])
        z = 2.0 * self.rng.integers(0, 2, size=tuple(shape)) - 1.0
        return torch.as_tensor(z, dtype=kw["dtype"]) if self.torch_side else jnp.asarray(z)


def test_lanczos_full_reorth_matches_jax():
    A = _spd(40)
    v0 = np.random.default_rng(1).standard_normal(40)
    j = jlz.lanczos(lambda v: jnp.asarray(A) @ v, jnp.asarray(v0), 25, full_reorth=True, store_basis=True)
    At = torch.as_tensor(A)
    t = tlz.lanczos(lambda v: At @ v, torch.as_tensor(v0), 25, full_reorth=True, store_basis=True)
    for field in ("alpha", "beta", "Q"):
        np.testing.assert_allclose(getattr(t, field).numpy(), np.asarray(getattr(j, field)), rtol=TOL, atol=TOL)
    assert int(t.num_valid) == int(j.num_valid) == 25


def test_lanczos_breakdown_is_masked_like_jax():
    """A start vector in a 3-dimensional invariant subspace breaks down
    after three steps; both packages zero the rest and count 3."""
    A = np.diag(np.arange(1.0, 11.0))
    v0 = np.zeros(10)
    v0[:3] = 1.0
    j = jlz.lanczos(lambda v: jnp.asarray(A) @ v, jnp.asarray(v0), 6)
    At = torch.as_tensor(A)
    t = tlz.lanczos(lambda v: At @ v, torch.as_tensor(v0), 6)
    assert int(t.num_valid) == int(j.num_valid) == 3
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t.beta.numpy(), np.asarray(j.beta), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", ["col", "bm"])
def test_lanczos_batched_matches_jax(layout):
    A = _spd(50, seed=2)
    V = np.random.default_rng(3).standard_normal((50, 4))
    V = V if layout == "col" else V.T
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    jmv = (lambda v: Aj @ v) if layout == "col" else (lambda v: v @ Aj)
    tmv = (lambda v: At @ v) if layout == "col" else (lambda v: v @ At)
    ja, jb, jn = jlz.lanczos_batched(jmv, jnp.asarray(V), 20, layout=layout)
    ta, tb, tn = tlz.lanczos_batched(tmv, torch.as_tensor(V), 20, layout=layout)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("layout,full_reorth", [("col", False), ("bm", False), ("col", True)])
def test_slq_logdet_matches_jax_with_injected_probes(monkeypatch, layout, full_reorth):
    m = 60
    A = _spd(m, seed=4)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    monkeypatch.setattr(jax.random, "rademacher", _Probes(7, torch_side=False))
    monkeypatch.setattr(tlz, "rademacher", _Probes(7, torch_side=True))
    jmv = (lambda v: v @ Aj) if layout == "bm" else (lambda v: Aj @ v)
    tmv = (lambda v: v @ At) if layout == "bm" else (lambda v: At @ v)
    kw = dict(num_probes=6, lanczos_iters=25, full_reorth=full_reorth, layout=layout)
    want = float(jlz.slq_logdet(jmv, m, key=jax.random.PRNGKey(0), dtype=jnp.float64, **kw))
    got = float(tlz.slq_logdet(tmv, m, generator=None, dtype=torch.float64, **kw))
    assert got == pytest.approx(want, rel=TOL)
    # The estimate is of log|A|: within SLQ's probe error of the exact value.
    assert got == pytest.approx(float(np.linalg.slogdet(A)[1]), rel=0.2)


def test_rademacher_draws_signs_from_the_generator():
    g = torch.Generator().manual_seed(3)
    z = tlz.rademacher((4, 1000), dtype=torch.float32, device="cpu", generator=g)
    assert set(torch.unique(z).tolist()) == {-1.0, 1.0} and abs(float(z.mean())) < 0.1
    z2 = tlz.rademacher((4, 1000), dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(z, z2)


def test_lowrank_preconditioners_match_jax():
    rng = np.random.default_rng(5)
    n, r = 80, 12
    F = rng.standard_normal((n, r)) * np.geomspace(1.0, 1e-3, r)
    w = np.geomspace(10.0, 0.1, r)
    sigma2 = 0.3
    Uj, lj = jpre.lowrank_spectral_factor(jnp.asarray(F), weights=jnp.asarray(w))
    Ut, lt = tpre.lowrank_spectral_factor(torch.as_tensor(F), weights=torch.as_tensor(w))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10, atol=1e-12)
    # Eigenvector signs are the solvers' choice; the operator is not.
    Mt = (Ut * lt) @ Ut.T
    np.testing.assert_allclose(Mt.numpy(), (F * w) @ F.T, rtol=0, atol=1e-10)
    v = rng.standard_normal((3, n))
    for layout in ("bm", "col"):
        vv = v if layout == "bm" else v.T
        jops = jpre.lowrank_sqrt_ops(Uj, lj, sigma2, layout=layout)
        tops = tpre.lowrank_sqrt_ops(Ut, lt, sigma2, layout=layout)
        for jo, to in zip(jops[:2], tops[:2]):
            np.testing.assert_allclose(to(torch.as_tensor(vv)).numpy(), np.asarray(jo(jnp.asarray(vv))),
                                       rtol=1e-10, atol=1e-12)
        assert float(tops[2]) == pytest.approx(float(jops[2]), rel=1e-12)
    pj = jpre.lowrank_preconditioner(jnp.asarray(F), jnp.asarray(w), sigma2)
    pt = tpre.lowrank_preconditioner(torch.as_tensor(F), torch.as_tensor(w), sigma2)
    np.testing.assert_allclose(pt(torch.as_tensor(v.T)).numpy(), np.asarray(pj(jnp.asarray(v.T))), rtol=1e-10)
    ops = tpre.lowrank_sqrt_ops_from_factor(torch.as_tensor(F), sigma2, weights=torch.as_tensor(w), layout="bm")
    want = jpre.lowrank_sqrt_ops(Uj, lj, sigma2, layout="bm")[0](jnp.asarray(v))
    np.testing.assert_allclose(ops[0](torch.as_tensor(v)).numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
