"""Parity of the port's CG solvers and the Kronecker deflation preconditioner
against the JAX package, on the CPU, on a small SPD Kronecker system
``⊗K_d + σ²I`` (float64 unless stated)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gp_grief_tpu.ops import cg as jcg
from gp_grief_tpu.ops import kron as jkron
from gp_grief_tpu.ops import precond as jpre
from gp_grief_tpu.ops.topk import top_p_kron_eigs as jtop
from gp_grief_tpu_torch.ops import cg as tcg
from gp_grief_tpu_torch.ops import kron as tkron
from gp_grief_tpu_torch.ops import precond as tpre
from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs as ttop

torch.set_num_threads(1)

SIZES = (5, 6, 7)
SIGMA2 = 0.05  # κ ≈ 600: plain and deflated CG
REFINE_SIGMA2 = 1.0  # κ ≈ 30: bf16 refinement converges (it needs κ·ε_bf16 < 1)


def _system(dtype=np.float64):
    rng = np.random.default_rng(0)
    Ks = []
    for m in SIZES:
        x = np.sort(rng.uniform(0, 3, m))
        Ks.append(np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.6) ** 2).astype(dtype))
    b = rng.standard_normal((math.prod(SIZES), 3)).astype(dtype)
    return Ks, b


def _ops(Ks, sigma2=SIGMA2):
    jK = [jnp.asarray(k) for k in Ks]
    tK = [torch.as_tensor(k) for k in Ks]

    def jmv(v):
        return jkron.kron_matvec(jK, v) + sigma2 * v

    def tmv(v):
        return tkron.kron_matvec(tK, v) + sigma2 * v

    return jK, tK, jmv, tmv


def _precond(jK, tK, rank=12):
    Qj, lj = jkron.kron_eigh(jK)
    Qt, lt = tkron.kron_eigh(tK)
    _, ij = jtop(lj, rank)
    _, it = ttop(lt, rank)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    return jpre.kron_deflation_preconditioner(Qj, lj, ij, SIGMA2), tpre.kron_deflation_preconditioner(Qt, lt, it, SIGMA2)


def _bm(op):
    return lambda v: op(v.T).T


def test_deflation_ops_match_jax():
    Ks, b = _system()
    jK, tK, _, _ = _ops(Ks)
    Qj, lj = jkron.kron_eigh(jK)
    Qt, lt = tkron.kron_eigh(tK)
    _, idx = jtop(lj, 12)
    jops = jpre.kron_deflation_sqrt_ops(Qj, lj, idx, SIGMA2)
    tops = tpre.kron_deflation_sqrt_ops(Qt, lt, torch.as_tensor(np.array(idx), dtype=torch.int64), SIGMA2)
    for jo, to in zip(jops[:2], tops[:2]):
        np.testing.assert_allclose(to(torch.as_tensor(b)).numpy(), np.asarray(jo(jnp.asarray(b))), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(to(torch.as_tensor(b[:, 0])).numpy(), np.asarray(jo(jnp.asarray(b[:, 0]))),
                                   rtol=1e-10, atol=1e-10)
    assert float(tops[2]) == pytest.approx(float(jops[2]), rel=1e-12)


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "deflated"])
@pytest.mark.parametrize("layout", ["col", "bm"])
def test_cg_solve_matches_jax(layout, precond):
    Ks, b = _system()
    jK, tK, jmv, tmv = _ops(Ks)
    jM, tM = _precond(jK, tK) if precond else (None, None)
    if layout == "bm":
        jmv, tmv, b = _bm(jmv), _bm(tmv), b.T.copy()
        jM, tM = (_bm(jM), _bm(tM)) if precond else (None, None)
    xj, ij = jcg.cg_solve(jmv, jnp.asarray(b), tol=1e-10, max_iters=300, M_inv=jM, layout=layout, return_info=True)
    xt, it = tcg.cg_solve(tmv, torch.as_tensor(b), tol=1e-10, max_iters=300, M_inv=tM, layout=layout, return_info=True)
    # The stopping test compares residuals that differ at rounding level, so
    # the counts may differ by one iteration.
    assert abs(it.iterations - int(ij.iterations)) <= 1 and it.iterations < 300
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-7, atol=1e-8)
    stop = 1e-10 * np.linalg.norm(b, axis=0 if layout == "col" else 1)
    assert np.all(it.residual_norm.numpy() <= stop) and np.all(np.asarray(ij.residual_norm) <= stop)
    # The single-vector form and a fixed iteration count.
    b1 = b[:, 0] if layout == "col" else b[0]
    np.testing.assert_allclose(
        tcg.cg_solve(tmv, torch.as_tensor(b1), fixed_iters=15, M_inv=tM, layout=layout).numpy(),
        np.asarray(jcg.cg_solve(jmv, jnp.asarray(b1), fixed_iters=15, M_inv=jM, layout=layout)),
        rtol=1e-9, atol=1e-10,
    )


def _bf16(t):
    """Round to bf16 and back: the fast matvec's operand rounding, the same in
    both packages."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.bfloat16).to(t.dtype)
    return t.astype(jnp.bfloat16).astype(t.dtype)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"], ids=["mixed", "mixed16"])
def test_cg_solve_refined_matches_jax(state_dtype):
    """float32 refinement with a bf16-operand fast matvec (simulated the same
    way in both packages) and an exact refresh; bm layout, as the model runs."""
    Ks, b = _system(np.float32)
    b = b.T.copy()
    sigma2 = np.float32(REFINE_SIGMA2)
    jK, tK, jmv, tmv = _ops(Ks, sigma2)

    def jfast(v):
        v32 = v.astype(jnp.float32)
        return jkron.kron_matvec([_bf16(k) for k in jK], _bf16(v32).T).T + sigma2 * v32

    def tfast(v):
        v32 = v.to(torch.float32)
        return tkron.kron_matvec([_bf16(k) for k in tK], _bf16(v32).T).T + sigma2 * v32

    kw = dict(tol=1e-6, inner_iters=20, max_restarts=10, layout="bm", return_info=True)
    xj, ij = jcg.cg_solve_refined(jfast, _bm(jmv), jnp.asarray(b),
                                  state_dtype=None if state_dtype is None else jnp.bfloat16, **kw)
    xt, it = tcg.cg_solve_refined(tfast, _bm(tmv), torch.as_tensor(b),
                                  state_dtype=None if state_dtype is None else torch.bfloat16, **kw)
    # Each restart cuts the residual by about κ·ε_bf16; a residual at the
    # threshold may take one restart more in one package.
    assert abs(it.iterations - int(ij.iterations)) <= kw["inner_iters"] and it.fallback_iterations == 0
    assert it.iterations < kw["inner_iters"] * kw["max_restarts"]
    rel = np.linalg.norm(xt.numpy() - np.asarray(xj)) / np.linalg.norm(np.asarray(xj))
    assert rel < 1e-5  # both within tol 1e-6 of the solution, on κ ≈ 30
    assert bool(torch.all(it.residual_norm <= 1e-6 * torch.linalg.norm(torch.as_tensor(b), dim=1)))


def test_cg_solve_refined_nan_poisoned_inner_solve_falls_back():
    """The RESULTS_r5 §12 regression: an inner solve that blows up to inf/NaN
    must not read as converged; both packages finish with exact CG and
    return the same accurate solution."""
    Ks, b = _system()
    b = b.T.copy()
    jK, tK, jmv, tmv = _ops(Ks, REFINE_SIGMA2)

    def jbad(v):
        return jnp.full_like(v, jnp.inf) * v

    def tbad(v):
        return torch.full_like(v, torch.inf) * v

    kw = dict(tol=1e-8, inner_iters=20, max_restarts=3, layout="bm", return_info=True)
    xj, ij = jcg.cg_solve_refined(jbad, _bm(jmv), jnp.asarray(b), **kw)
    xt, it = tcg.cg_solve_refined(tbad, _bm(tmv), torch.as_tensor(b), **kw)
    assert it.fallback_iterations > 0 and bool(torch.isfinite(xt).all())
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-7, atol=1e-8)
    ref = np.linalg.solve(np.asarray(jkron.kron_expand(jK)) + REFINE_SIGMA2 * np.eye(b.shape[1]), b.T).T
    np.testing.assert_allclose(xt.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_cg_value_solves_refuse_a_required_gradient():
    """``implicit_diff=False`` keeps a value solve: a required gradient
    raises rather than differentiating through the iterations."""
    Ks, b = _system()
    _, _, _, tmv = _ops(Ks)
    bt = torch.as_tensor(b[:, 0]).requires_grad_()
    with pytest.raises(NotImplementedError, match="value solve"):
        tcg.cg_solve(tmv, bt, implicit_diff=False)
    with pytest.raises(NotImplementedError, match="value solve"):
        tcg.cg_solve_refined(tmv, tmv, bt, implicit_diff=False)
    with torch.no_grad():
        assert tcg.cg_solve(tmv, bt, tol=1e-8).shape == bt.shape
    with pytest.raises(ValueError, match="layout"):
        tcg.cg_solve(tmv, bt.detach(), layout="row")


def _refined_two_applies(matvec_fast, matvec_exact, rhs, tol, inner_iters, max_restarts, M_inv, layout, state_dtype):
    """The refinement loop as it was before the residual was carried across
    restarts: the exact operator applied twice per restart to the same
    iterate.  The oracle of the carried residual's bits."""
    _, _colnorm, _bc = tcg._reducers(layout)
    bnorm = _colnorm(rhs)
    stop = tol * torch.clamp_min(bnorm, torch.finfo(rhs.dtype).tiny)
    x = torch.zeros_like(rhs)
    x_best = x
    rnorm = rnorm_best = bnorm
    outer = 0
    while outer < max_restarts and bool(torch.any(rnorm_best > stop)):
        if bool(torch.all(rnorm > 100.0 * torch.maximum(rnorm_best, stop))):
            break
        r = rhs - matvec_exact(x)
        d, _ = tcg._cg_fixed(matvec_fast, r, None, inner_iters, M_inv, layout, state_dtype)
        x = x + d
        rnorm = _colnorm(rhs - matvec_exact(x))
        rnorm = torch.where(torch.isfinite(rnorm), rnorm, torch.full_like(rnorm, torch.inf))
        better = rnorm < rnorm_best
        x_best = torch.where(_bc(better), x, x_best)
        rnorm_best = torch.minimum(rnorm, rnorm_best)
        outer += 1
    fallback = 0
    if bool(torch.any(rnorm_best > stop)):
        xf, info = tcg._cg_raw(matvec_exact, rhs, x_best, tol, inner_iters * max_restarts, M_inv, layout)
        better = info.residual_norm < rnorm_best
        x_best = torch.where(_bc(better), xf, x_best)
        rnorm_best = torch.minimum(info.residual_norm, rnorm_best)
        fallback = info.iterations
    return x_best, rnorm_best, outer, fallback


@pytest.mark.parametrize("case", ["mixed", "mixed16", "fallback"])
def test_cg_solve_refined_applies_the_exact_operator_once_per_restart(case):
    """A counting exact operator: 1 + restarts applies (plus the fallback's
    1 + its iterations), where the old loop made 2 per restart; the
    solution, residuals and counts are the old loop's bits."""
    Ks, b = _system(np.float32 if case != "fallback" else np.float64)
    rhs = torch.as_tensor(b.T.copy())
    _, tK, _, tmv = _ops(Ks, REFINE_SIGMA2)
    exact = _bm(tmv)
    if case == "fallback":
        def fast(v):
            return torch.full_like(v, torch.inf) * v
    else:
        def fast(v):
            v32 = v.to(torch.float32)
            return tkron.kron_matvec([_bf16(k) for k in tK], _bf16(v32).T).T + REFINE_SIGMA2 * v32
    calls = [0]

    def counted(v):
        calls[0] += 1
        return exact(v)

    args = (1e-8 if case == "fallback" else 1e-6, 20, 3 if case == "fallback" else 10, None, "bm",
            torch.bfloat16 if case == "mixed16" else None)
    with torch.no_grad():
        x, rnorm, outer, fallback = tcg._refined(fast, counted, rhs, *args)
        new_calls = calls[0]
        calls[0] = 0
        x_old, rnorm_old, outer_old, fallback_old = _refined_two_applies(fast, counted, rhs, *args)
    assert new_calls == 1 + outer + (1 + fallback if fallback else 0)
    assert calls[0] == 2 * outer_old + (1 + fallback_old if fallback_old else 0)
    assert (outer, fallback) == (outer_old, fallback_old) and outer > 0
    assert (fallback > 0) == (case == "fallback")
    assert torch.equal(x, x_old) and torch.equal(rnorm, rnorm_old)
    # The public entry point runs the same loop.
    calls[0] = 0
    xs, info = tcg.cg_solve_refined(fast, counted, rhs, tol=args[0], inner_iters=20, max_restarts=args[2],
                                    layout="bm", state_dtype=args[5], return_info=True, implicit_diff=False)
    assert torch.equal(xs, x) and calls[0] == new_calls and info.iterations == 20 * outer
