"""GP-GRIEF's iterative NLML and the fused CG + SLQ driver against the JAX
package, float64 on the CPU, on the same NumPy inputs.

* The fused step, ``fused_cg_slq_segment`` and the host driver on a seeded
  dense SPD operator (κ = 10) with the same NumPy probes: the same
  arithmetic, so states and log-dets agree to 1e-12 relative.  The chunks
  are 12 steps: once Lanczos without reorthogonalization loses
  orthogonality (after ~12 steps on this operator; in CG too), the two
  frameworks' roundings grow apart geometrically.
* The host quadrature of a probe chunk: the same float64 NumPy code, 1e-13.
* The model's NLML (n = 300 in 3-D, p = 40): with ``precond_rank = p`` the
  whitened operator is the identity, so the estimate does not depend on the
  probes and equals the closed form; with ``r < p`` both packages are handed
  the same NumPy probes (``tools/ski_reference_jax.NumpyProbes`` for
  ``jax.random.rademacher``, ``chip_smoke.NumpyProbes`` for the port's
  ``ops.lanczos.rademacher``).  CG runs to 1e-12, so the two differ by
  rounding and by where CG stops: 1e-9 relative.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
import gp_grief_tpu_torch.ops.lanczos as tlz
from gp_grief_tpu.ops import fused as jfused
jlz = importlib.import_module("gp_grief_tpu.ops.lanczos")  # the package exports a function of that name
from gp_grief_tpu.ops.cg import _reducers as j_reducers
from gp_grief_tpu_torch.models import gp_grief as tgrief
from gp_grief_tpu_torch.ops import fused as tfused
from gp_grief_tpu_torch.ops.cg import _reducers as t_reducers
from gp_grief_tpu_torch.ops.precond import check_whitening
from tools import ski_reference_jax as ref

torch.set_num_threads(1)

TOL = 1e-12
MODEL_TOL = 1e-9
ITER = dict(num_probes=4, lanczos_iters=30, cg_tol=1e-12, cg_iters=500)


@pytest.fixture
def probes(monkeypatch):
    jp, tp = ref.NumpyProbes(), cs.NumpyProbes()
    monkeypatch.setattr(jax.random, "rademacher", jp)
    monkeypatch.setattr(tlz, "rademacher", tp)
    return jp, tp


def _dense_spd(m=60, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    A = (Q * np.geomspace(0.5, 5.0, m)) @ Q.T
    return (A + A.T) / 2, rng.standard_normal((1, m)), cs.ski_probe(0, (3, m))


def _cg_start(lib, rhs):
    rz = (rhs * rhs).sum(1)
    zeros = lib.zeros_like(rhs)
    dead = jnp.zeros(rz.shape, bool) if lib is jnp else torch.zeros(rz.shape, dtype=torch.bool)
    return (zeros, rhs, rhs, rhs, rz, dead)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("freeze", [None, 1e-6], ids=["pure", "freeze"])
def test_fused_step_and_segment_match_jax(freeze):
    A, b, Z = _dense_spd()
    jop, top = (lambda v: v @ jnp.asarray(A)), (lambda v: v @ torch.as_tensor(A))
    jb, tb = jnp.asarray(b), torch.as_tensor(b)
    bn2 = float((b * b).sum())
    fz = None if freeze is None else freeze * bn2  # freeze at a relative residual of 1e-3
    jst = jfused.make_fused_cg_lanczos_step(jop, *j_reducers("bm", None), freeze_rz=fz)
    tst = tfused.make_fused_cg_lanczos_step(top, *t_reducers("bm"), freeze_rz=fz)
    jZ, tZ = jnp.asarray(Z), torch.as_tensor(Z)
    jq0, tq0 = jZ / jnp.linalg.norm(jZ, axis=1, keepdims=True), tZ / torch.linalg.norm(tZ, dim=1, keepdim=True)
    jlz0 = (jq0, jnp.zeros_like(jq0), jnp.zeros((3,)), jnp.ones((3,), bool))
    tlz0 = (tq0, torch.zeros_like(tq0), torch.zeros((3,), dtype=torch.float64), torch.ones((3,), dtype=torch.bool))
    jcg, jl, jo = jst(_cg_start(jnp, jb), jlz0)
    tcg, tl, to = tst(_cg_start(torch, tb), tlz0)
    for a, c in zip(tcg + tl + to, jcg + jl + jo):
        _close(a, c)
    # A whole chunk; with the threshold, CG converges to it and freezes.
    jcg, jld = jfused.fused_cg_slq_segment(jop, _cg_start(jnp, jb), jZ, 12, freeze_rz=fz)
    tcg, tld = tfused.fused_cg_slq_segment(top, _cg_start(torch, tb), tZ, 12, freeze_rz=fz)
    for a, c in zip(tcg, jcg):
        _close(a, c)
    assert float(tld) == pytest.approx(float(jld), rel=TOL)
    assert bool(tcg[5].all()) == (freeze is not None)


def test_driver_matches_jax_on_a_dense_operator(probes):
    A, b, _ = _dense_spd(seed=1)
    kw = dict(num_probes=3, lanczos_iters=12, probe_chunk=3, cg_tol=1e-10, cg_iters=200, cg_segment_iters=5)
    xj, ldj, itj = jfused.fused_cg_slq_segmented(lambda v: v @ jnp.asarray(A), jnp.asarray(b), A.shape[0],
                                                 jax.random.PRNGKey(0), **kw)
    xt, ldt, itt = tfused.fused_cg_slq(lambda v: v @ torch.as_tensor(A), torch.as_tensor(b), generator=None, **kw)
    assert probes[0].calls == probes[1].calls == 1
    assert itt == itj > 12 and (itt - 12) % 5 == 0  # the probe chunk, then whole segments
    _close(xt.numpy(), np.asarray(xj))
    _close(xt.numpy()[0], np.linalg.solve(A, b[0]), tol=1e-9)
    assert ldt == pytest.approx(ldj, rel=TOL)


def test_chunk_quadrature_matches_jax():
    rng = np.random.default_rng(3)
    k, R = 12, 5
    a = rng.uniform(1, 3, (k, R))
    b = rng.uniform(0.1, 0.5, (k, R))
    alive = np.ones((k, R), bool)
    alive[7:, 1] = False  # one recurrence broke down after 7 steps
    a[7:, 1] = b[6:, 1] = 0.0
    zn = rng.uniform(50, 60, R)
    rows = ([a[:5], a[5:]], [b[:5], b[5:]], [alive[:5], alive[5:]])
    got = tlz._chunk_quadrature_total(*rows, zn, k)
    assert got == pytest.approx(jlz._chunk_quadrature_total(*rows, zn, k), rel=1e-13)
    assert tlz._probe_chunk_sizes(10, 4) == jlz._probe_chunk_sizes(10, 4) == [4, 4, 2]


def _pair(n=300, d=3, p=40):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.3 * x[:, 2] + 0.1 * rng.standard_normal(n)
    kw = dict(n_eigs=p, noise_var=0.05)
    jm = gpx.GPGriefModel(x, y, [gpx.make_kernel("rbf", lengthscale=0.6 + 0.1 * i) for i in range(d)],
                          gpx.InducingGrid.build(x, mbar=6), **kw)
    tm = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.6 + 0.1 * i) for i in range(d)],
                          gpt.InducingGrid.build(x, mbar=6), device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("segmented", [False, True], ids=["one_chunk", "segmented"])
def test_full_rank_whitening_gives_the_closed_form(segmented):
    """precond_rank = p: M = ΦWΦᵀ + σ²I is the operator itself."""
    jm, tm = _pair()
    seg = dict(cg_segment_iters=10, probe_chunk=2) if segmented else {}
    lj = (jm.log_likelihood_iterative_segmented if segmented else jm.log_likelihood_iterative)(
        precond_rank=40, **ITER, **seg)
    lt = (tm.log_likelihood_iterative_segmented if segmented else tm.log_likelihood_iterative)(
        precond_rank=40, **ITER, **seg)
    assert lt == pytest.approx(lj, rel=MODEL_TOL)
    assert lt == pytest.approx(tm.log_likelihood(), rel=MODEL_TOL)


@pytest.mark.parametrize("rank", [20, 0])
@pytest.mark.parametrize("segmented", [False, True], ids=["one_chunk", "segmented"])
def test_same_probes_match_jax(probes, rank, segmented):
    """One probe chunk: the JAX package traces its draw once per chunk size,
    so its chunks of one size reuse one draw; with one chunk both packages
    draw exactly once."""
    jm, tm = _pair()
    seg = dict(cg_segment_iters=10, probe_chunk=ITER["num_probes"]) if segmented else {}
    lj = (jm.log_likelihood_iterative_segmented if segmented else jm.log_likelihood_iterative)(
        precond_rank=rank, **ITER, **seg)
    lt = (tm.log_likelihood_iterative_segmented if segmented else tm.log_likelihood_iterative)(
        precond_rank=rank, **ITER, **seg)
    assert probes[0].calls == probes[1].calls == 1
    assert lt == pytest.approx(lj, rel=MODEL_TOL)


@pytest.mark.parametrize("rank", [20, 0])
def test_fuse_probes_on_and_off_agree(rank):
    """The same probes (one generator seed, drawn in the same order); only
    where CG runs differs."""
    _, tm = _pair()
    kw = dict(precond_rank=rank, cg_segment_iters=10, probe_chunk=2, **ITER)
    fused = tm.log_likelihood_iterative_segmented(fuse_probes=True, **kw)
    it_fused = tm.cg_iterations
    apart = tm.log_likelihood_iterative_segmented(fuse_probes=False, **kw)
    assert apart == pytest.approx(fused, rel=MODEL_TOL)
    assert it_fused >= 2 * ITER["lanczos_iters"] and tm.cg_iterations % 10 == 0


def test_phi_is_built_once_per_parameter_values(monkeypatch):
    _, tm = _pair()
    calls = []
    build = tgrief.phi
    monkeypatch.setattr(tgrief, "phi", lambda *a, **k: calls.append(1) or build(*a, **k))
    tm.stats_chunk = 128  # three row chunks into one (n, p) tensor
    kw = dict(precond_rank=20, **ITER)
    first = tm.log_likelihood_iterative(**kw)
    assert len(calls) == 3
    assert tm.log_likelihood_iterative(**kw) == first and len(calls) == 3
    with torch.no_grad():
        tm.log_w.add_(0.1)
    tm.log_likelihood_iterative(**kw)
    assert len(calls) == 6


def test_check_whitening_catches_a_factor_that_does_not_whiten():
    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((500, 6)))
    lam, sigma2 = torch.as_tensor(np.geomspace(1.0, 1e4, 6)), 0.01
    assert check_whitening(torch.as_tensor(U), lam, sigma2) < 1e-13
    U[:, 0] *= 1.001  # ‖UᵀU − I‖ = 2e-3, above the bound c/(b − c) ≈ 1e-3
    with pytest.raises(RuntimeError, match="not orthonormal enough"):
        check_whitening(torch.as_tensor(U), lam, sigma2)


@pytest.mark.parametrize("orthonormal", [True, False])
def test_whitening_logdet_is_the_applied_whitenings(orthonormal):
    """``whitening_logdet`` is ``−2 log|S|`` of the ``S = M^{-1/2}`` that
    ``lowrank_sqrt_ops`` applies, formed densely here; for an orthonormal
    ``U`` it is ``lowrank_sqrt_ops``'s own ``logdet_M``."""
    from gp_grief_tpu_torch.ops.precond import gram64, lowrank_sqrt_ops, whitening_logdet

    rng = np.random.default_rng(5)
    n, r, sigma2 = 80, 6, 0.2
    U, _ = np.linalg.qr(rng.standard_normal((n, r)))
    if not orthonormal:
        U = U * (1.0 + 1e-3 * rng.standard_normal(r))[None, :]
    U, lam = torch.as_tensor(U), torch.as_tensor(np.geomspace(1.0, 1e4, r))
    _, M_isqrt, ld = lowrank_sqrt_ops(U, lam, sigma2)
    S = M_isqrt(torch.eye(n, dtype=torch.float64))
    got = float(whitening_logdet(gram64(U), lam, sigma2, n))
    assert got == pytest.approx(-2.0 * float(torch.linalg.slogdet(S)[1]), rel=1e-12)
    if orthonormal:
        assert got == pytest.approx(float(ld), rel=1e-12)
    else:
        assert abs(got - float(ld)) > 1e-3


def test_spectral_factor_past_the_gram_rows():
    """The top-r pairs of a float32 factor, here of 131,572 rows, come from
    the float64 p × p problem: ``U`` orthonormal to float32's resolution,
    the top eigenvalues of ``F W Fᵀ``, and the same ones as CholeskyQR2's
    (float64's) route."""
    from gp_grief_tpu_torch.ops import precond

    rng = np.random.default_rng(6)
    n, p, r = 131_572, 12, 8
    F = torch.as_tensor(rng.standard_normal((n, p)) * np.geomspace(1.0, 30.0, p), dtype=torch.float32)
    w = torch.as_tensor(np.geomspace(1.0, 0.1, p), dtype=torch.float32)
    U, lam = precond.lowrank_spectral_factor(F, weights=w, top_r=r)
    assert U.shape == (n, r) and U.dtype == torch.float32
    G = precond.gram64(U)
    assert float(torch.linalg.matrix_norm(G - torch.eye(r, dtype=G.dtype), ord=2)) < 1e-5
    Fw = F.double() * w.double().sqrt()
    top = torch.linalg.eigvalsh(Fw.T @ Fw)[-r:]
    assert torch.allclose(lam.double(), top, rtol=1e-5)
    # U spans the top eigenvectors: U diag(lam) Uᵀ U = F W Fᵀ U.
    Ud = U.double()
    assert torch.allclose(Ud * lam.double(), Fw @ (Fw.T @ Ud), rtol=0, atol=1e-4 * float(lam.max()))
    _, lam_cqr = precond.lowrank_spectral_factor(F.double(), weights=w.double(), top_r=r)
    assert torch.allclose(lam.double(), lam_cqr, rtol=1e-5)


def test_full_factors_keep_cholesky_qr2():
    """A full factor (no ``top_r``) keeps CholeskyQR2, whose ``U`` stays
    orthonormal on an ill-conditioned float32 factor (κ(F) = 1e4), where
    the float64 p × p route's does not."""
    from gp_grief_tpu_torch.ops import precond

    rng = np.random.default_rng(7)
    n, p = 20_000, 32
    Q, _ = np.linalg.qr(rng.standard_normal((n, p)))
    R, _ = np.linalg.qr(rng.standard_normal((p, p)))
    F = torch.as_tensor((Q * np.geomspace(1.0, 1e-4, p)) @ R, dtype=torch.float32)

    def defect(U):
        G = precond.gram64(U)
        return float(torch.linalg.matrix_norm(G - torch.eye(p, dtype=G.dtype), ord=2))

    U, _ = precond.lowrank_spectral_factor(F)
    U64, _ = precond._spectral_factor64(F, None, p)
    assert defect(U) < 1e-5 < defect(U64)
