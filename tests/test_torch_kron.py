"""Parity of the port's Kronecker algebra, Khatri-Rao matvec, diagonal
kernels, the fast Kronecker matvec and the plain versions of kernels K2/K3
against the JAX package, on the CPU.

The same NumPy inputs go through both packages.  The algebra is compared in
float64 to ~1e-12; the kernels' plain versions in float32 against the JAX
Pallas kernels run in interpret mode, at the shapes of tests/test_pallas.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gp_grief_tpu as gpx
import gp_grief_tpu_torch as gpt
from gp_grief_tpu.ops import khatri_rao as jkr
from gp_grief_tpu.ops import kron as jkron
from gp_grief_tpu.ops import kron_fast as jfast
from gp_grief_tpu.ops.pallas import kron_pallas as jpal
from gp_grief_tpu_torch.kernels.diag import cov_diag
from gp_grief_tpu_torch.ops import khatri_rao as tkr
from gp_grief_tpu_torch.ops import kron as tkron
from gp_grief_tpu_torch.ops import kron_fast as tfast
from gp_grief_tpu_torch.ops.cuda import kron as tcuda

torch.set_num_threads(1)


def _factors(rng, sizes, outs=None, scale=True):
    outs = outs or sizes
    return [rng.standard_normal((o, m)) / (np.sqrt(m) if scale else 1.0) for o, m in zip(outs, sizes)]


def _t(arrs, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype) for a in arrs]


def _j(arrs, dtype=jnp.float64):
    return [jnp.asarray(a, dtype=dtype) for a in arrs]


@pytest.mark.parametrize("B", [None, 3], ids=["vector", "batched"])
@pytest.mark.parametrize("sizes,outs", [((4, 5, 6), None), ((3, 7, 2, 5), (4, 7, 3, 5))], ids=["square", "rect"])
def test_kron_matvec_matmat_match_jax(sizes, outs, B):
    rng = np.random.default_rng(1)
    fs = _factors(rng, sizes, outs)
    v = rng.standard_normal((math.prod(sizes),) if B is None else (math.prod(sizes), B))
    want = np.asarray(jkron.kron_matvec(_j(fs), jnp.asarray(v)))
    np.testing.assert_allclose(tkron.kron_matvec(_t(fs), torch.as_tensor(v)).numpy(), want, rtol=1e-12, atol=1e-12)
    if B is not None:
        got = tkron.kron_matmat(_t(fs), torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(jkron.kron_matmat(_j(fs), jnp.asarray(v))), rtol=1e-12, atol=1e-12)
    assert tkron.kron_shapes(_t(fs)) == jkron.kron_shapes(_j(fs))


def test_kron_diag_logdet_and_schur_solve_match_jax():
    rng = np.random.default_rng(2)
    sizes = (4, 5, 6)
    Ks = []
    for m in sizes:
        A = rng.standard_normal((m, m))
        Ks.append(A @ A.T / m + 0.5 * np.eye(m))
    np.testing.assert_allclose(tkron.kron_diag(_t(Ks)).numpy(), np.asarray(jkron.kron_diag(_j(Ks))), rtol=1e-13)
    Qj, lj = jkron.kron_eigh(_j(Ks))
    Qt, lt = tkron.kron_eigh(_t(Ks))
    assert float(tkron.kron_logdet_from_eigs(lt)) == pytest.approx(float(jkron.kron_logdet_from_eigs(lj)), rel=1e-12)
    b = rng.standard_normal((120, 2))
    want = np.asarray(jkron.kron_solve_schur(Qj, lj, jnp.asarray(b), 0.3))
    got = tkron.kron_solve_schur(Qt, lt, torch.as_tensor(b), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tkron.kron_solve_schur(Qt, lt, torch.as_tensor(b[:, 0]), 0.3).numpy(), want[:, 0],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("B", [None, 2], ids=["vector", "batched"])
def test_khatri_rao_matches_jax(B):
    rng = np.random.default_rng(3)
    A = [rng.standard_normal((9, m)) for m in (3, 4, 5)]
    v = rng.standard_normal((60,) if B is None else (60, B))
    np.testing.assert_allclose(tkr.kr_expand(_t(A)).numpy(), np.asarray(jkr.kr_expand(_j(A))), rtol=1e-14)
    want = np.asarray(jkr.kr_matvec(_j(A), jnp.asarray(v)))
    np.testing.assert_allclose(tkr.kr_matvec(_t(A), torch.as_tensor(v)).numpy(), want, rtol=1e-12, atol=1e-12)


def test_cov_diag_matches_jax_and_names_unported_kernels():
    from gp_grief_tpu.kernels.diag import cov_diag as jdiag
    from gp_grief_tpu.kernels.extra import Linear

    rng = np.random.default_rng(4)
    x = rng.standard_normal((11, 3))
    jk = [gpx.make_kernel("rbf", variance=1.5), gpx.make_kernel("matern32", variance=0.7)]
    tk = [gpt.make_kernel("rbf", variance=1.5), gpt.make_kernel("matern32", variance=0.7)]
    dims = [(0, 2), (1,)]
    want = np.asarray(jdiag(jk, jnp.asarray(x), dims=dims))
    np.testing.assert_allclose(cov_diag(tk, torch.as_tensor(x), dims=dims).detach().numpy(), want, rtol=1e-14)
    np.testing.assert_allclose(cov_diag(tk[0], torch.as_tensor(x)).detach().numpy(), 1.5, rtol=1e-14)
    with pytest.raises(NotImplementedError, match="Linear"):
        cov_diag(Linear(jnp.zeros(3)), torch.as_tensor(x))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("sizes,outs,B", [
    ((8, 16, 8, 16, 8), None, 1),       # grouped into 1024-wide super-factors
    ((40, 50), (30, 50), 2),            # rectangular factor breaks a group
    ((3, 130), None, 1),                # a >=128-wide pass
], ids=["d5", "rect", "wide"])
def test_kron_matvec_fast_chain_matches_jax(sizes, outs, B, precision):
    """The cyclic chain (impl="xla") in float64: "default" leaves float64
    operands at full precision, as XLA's CPU dot does."""
    rng = np.random.default_rng(5)
    fs = _factors(rng, sizes, outs)
    v = rng.standard_normal((math.prod(sizes), B))
    jprec = jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    want = np.asarray(jfast.kron_matvec_fast(_j(fs), jnp.asarray(v), precision=jprec, impl="xla"))
    got = tfast.kron_matvec_fast(_t(fs), torch.as_tensor(v), precision=precision, impl="xla").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    auto = tfast.kron_matvec_fast(_t(fs), torch.as_tensor(v[:, 0]), precision=precision).numpy()
    np.testing.assert_allclose(auto, want[:, 0], rtol=1e-10, atol=1e-12)
    gj = jfast.group_factors(_j(fs))
    gt = tfast.group_factors(_t(fs))
    assert [tuple(g.shape) for g in gt] == [tuple(g.shape) for g in gj]


def test_kron_matvec_fast_float32_default_rounds_wide_passes():
    """float32 at "default": passes of width >= 128 take bf16-rounded
    operands (f32 accumulation); narrower passes stay exact."""
    rng = np.random.default_rng(6)
    fs = _t(_factors(rng, (16, 16, 4)), torch.float32)
    v = torch.as_tensor(rng.standard_normal(1024), dtype=torch.float32)
    exact = tkron.kron_matvec([f.double() for f in fs], v.double())
    got = tfast.kron_matvec_fast(fs, v, precision="default", impl="xla").double()
    rel = float(torch.linalg.norm(got - exact) / torch.linalg.norm(exact))
    assert 1e-4 < rel < 2e-2  # bf16-class, not exact
    hi = tfast.kron_matvec_fast(fs, v, precision="highest", impl="xla").double()
    assert float(torch.linalg.norm(hi - exact) / torch.linalg.norm(exact)) < 1e-6


def test_kron_matvec_fast_contract():
    fs = _t(_factors(np.random.default_rng(7), (4, 4, 4)), torch.float32)
    v = torch.ones(64)
    for impl in ("slab", "fused"):  # the kernels need CUDA tensors
        with pytest.raises(ValueError, match=impl):
            tfast.kron_matvec_fast(fs, v, impl=impl)
    with pytest.raises(NotImplementedError, match="SKI"):
        tfast.kron_matvec_fast(fs, v, precision="BF16_BF16_F32_X3")
    with pytest.raises(ValueError, match="precision"):
        tfast.kron_matvec_fast(fs, v, precision="fastest")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _exact(fs, v):
    return tkron.kron_matvec([torch.as_tensor(np.asarray(f), dtype=torch.float64) for f in fs],
                             torch.as_tensor(np.asarray(v), dtype=torch.float64)).numpy()


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("sizes", [(4, 4, 8, 8, 8), (4, 16, 8, 16, 8), (4, 4, 4, 4, 16, 16)], ids=["d5", "d5pair", "d6"])
def test_slab_plain_version_matches_jax_interpret(sizes, B):
    """K2's plain version against the TPU slab kernel in interpret mode,
    float32, both grades.  Exact: the JAX slab's hi/lo split is X3-grade
    (~1e-5).  Fast: the plain version rounds operands to bf16 (the kernel's
    grade); XLA's CPU dot ignores DEFAULT, so JAX stays near exact and the
    two sit in the bf16 class of each other."""
    rng = np.random.default_rng(8)
    fs = [f.astype(np.float32) for f in _factors(rng, sizes)]
    v = rng.standard_normal((math.prod(sizes), B)).astype(np.float32)
    exact = _exact(fs, v)
    for prec, jprec, mid, tol in [("highest", jax.lax.Precision.HIGHEST, None, 5e-5),
                                  ("default", jax.lax.Precision.DEFAULT, torch.bfloat16, 2e-2)]:
        want = np.asarray(jpal.kron_matvec_slab(_j(fs, jnp.float32), jnp.asarray(v), precision=jprec,
                                                interpret=True, mid_dtype=None if mid is None else jnp.bfloat16))
        got = tcuda.kron_matvec_slab(_t(fs, torch.float32), torch.as_tensor(v), precision=prec, mid_dtype=mid)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < tol
        assert _rel(got.numpy(), exact) < (1e-6 if prec == "highest" else 2e-2)


@pytest.mark.parametrize("sizes,eye", [
    ((12, 24, 96), 0), ((12, 24, 96), 8), ((96, 128), 0), ((20, 28, 96), 0), ((8, 12, 24, 96), -1),
])
def test_fused_plain_version_matches_jax_interpret(sizes, eye):
    """K3's plain version against the TPU fused kernel in interpret mode,
    float32, both grades (the shapes of tests/test_pallas.py)."""
    rng = np.random.default_rng(9)
    fs = [f.astype(np.float32) for f in _factors(rng, sizes)]
    if eye > 0:
        fs = [np.eye(eye, dtype=np.float32)] + fs
    v = rng.standard_normal(math.prod(f.shape[1] for f in fs)).astype(np.float32)
    exact = _exact(fs, v)
    for prec, jprec, tol in [("highest", jax.lax.Precision.HIGHEST, 1e-5), ("default", jax.lax.Precision.DEFAULT, 3e-2)]:
        want = np.asarray(jpal.kron_matvec_fused(_j(fs, jnp.float32), jnp.asarray(v), precision=jprec, interpret=True))
        got = tcuda.kron_matvec_fused(_t(fs, torch.float32), torch.as_tensor(v), precision=prec).numpy()
        assert _rel(got, want) < tol
        assert _rel(got, exact) < (1e-6 if prec == "highest" else 3e-2)


def test_plain_version_bf16_input_and_rectangular_factors():
    """A bf16 vector forces the fast grade and returns bf16; rectangular
    factors (K3) contract to their row counts."""
    rng = np.random.default_rng(10)
    fs = _t(_factors(rng, (12, 24, 96), (10, 30, 100)), torch.float32)
    v = torch.as_tensor(rng.standard_normal(12 * 24 * 96), dtype=torch.float32)
    out = tcuda.kron_matvec_fused(fs, v.to(torch.bfloat16), precision="highest")
    assert out.dtype == torch.bfloat16 and out.shape == (10 * 30 * 100,)
    exact = tkron.kron_matvec([f.double() for f in fs], v.double())
    assert _rel(out.double().numpy(), exact.numpy()) < 3e-2
    assert _rel(tcuda.kron_matvec_fused(fs, v).double().numpy(), exact.numpy()) < 1e-6


_GATE_SHAPES = [  # (factor shapes, B)
    ([(32, 32)] * 5, 1), ([(8, 8)] + [(512, 512)] * 2, 1), ([(128, 128)] * 3, 1),
    ([(24, 24), (48, 48), (24, 24)], 1), ([(512, 512)] * 2, 8), ([(16, 16), (12, 12)], 1),
    ([(512, 512)] * 2, 1), ([(512, 512)] * 2, 128), ([(100, 100)] * 3, 1), ([(8, 8), (24, 24), (48, 48), (96, 96)], 1),
    ([(4, 4), (4, 4), (8, 8), (8, 8), (8, 8)], 1), ([(4, 4), (16, 16), (8, 16), (16, 16), (8, 8)], 1),
    ([(32, 32)] * 5, 4), ([(16, 16)] * 4, 1), ([(12, 12), (24, 24), (96, 96)], 1), ([(96, 96), (128, 128)], 1),
    ([(10, 12), (30, 24), (100, 96)], 1), ([(2, 2)] * 18, 1), ([(64, 64)] * 3, 1), ([(1024, 1024)] * 2, 1),
]


@pytest.mark.parametrize("shapes,B", _GATE_SHAPES)
def test_routing_gates_match_jax(shapes, B):
    """The copied gates route every shape as the JAX package does."""
    tf = [torch.zeros(s, dtype=torch.float32) for s in shapes]
    jf = [jnp.zeros(s, dtype=jnp.float32) for s in shapes]
    assert tcuda.slab_schedule_applicable(tf, B) == jpal.slab_schedule_applicable(jf, B)
    for fast in (False, True):
        for feasible_only in (False, True):
            assert tcuda.fused_schedule_applicable(tf, B, fast=fast, feasible_only=feasible_only) == \
                jpal.fused_schedule_applicable(jf, B, fast=fast, feasible_only=feasible_only)
    ms, outs = [s[1] for s in shapes], [s[0] for s in shapes]
    assert tcuda._fused_schedule(ms, outs, B, 4) == jpal._fused_schedule(ms, outs, B, 4)


def test_grid_shapes_route_to_their_kernels():
    """32^5 is slab-applicable (the mixed inner matvec runs K2); 8x512x512
    plans mid (0, 0) + tail (512, 512) and passes the exact-grade gate (K3)."""
    assert tcuda.slab_schedule_applicable([torch.zeros(32, 32)] * 5, 1)
    f3 = [torch.zeros(8, 8), torch.zeros(512, 512), torch.zeros(512, 512)]
    assert tcuda._fused_schedule([8, 512, 512], [8, 512, 512], 1, 4) == ([(0, 0)], 1)
    assert tcuda.fused_schedule_applicable(f3, 1) and not tcuda.slab_schedule_applicable(f3, 1)


def test_hopper_plans():
    """The kernels' own pass plan: as few passes as shared memory allows."""
    assert tcuda._hopper_plan([32] * 5, [32] * 5, 1) == [(2, 4, 1), (0, 1, 32)]
    assert tcuda._hopper_plan([8, 512, 512], [8, 512, 512], 1) == [(2, 2, 0), (1, 1, 0), (0, 0, 128)]
    for ms, B in [((12, 24, 96), 1), ((4, 16, 8, 16, 8), 3), ((96, 128), 1), ((3, 70, 5, 9), 2)]:
        plan = tcuda._hopper_plan(list(ms), list(ms), B)
        covered = sorted(a for i, j, _ in plan for a in range(i, j + 1))
        assert covered == list(range(len(ms)))
        for i, j, P in plan:
            assert (P == 0) == (i == j and ms[i] > 64)
            if P:
                assert tcuda._tile_smem_bytes(ms[i : j + 1], ms[i : j + 1], P) <= tcuda._SMEM_LIMIT


@pytest.mark.parametrize("which", ["slab", "fused"])
def test_wrapper_vjp_matches_jax(which):
    """The wrappers' backward is the plain chain's VJP, as the JAX custom VJP."""
    rng = np.random.default_rng(11)
    sizes = (4, 4, 8, 8, 8) if which == "slab" else (12, 24, 96)
    fs = [f.astype(np.float32) for f in _factors(rng, sizes)]
    m = math.prod(sizes)
    v, g = rng.standard_normal(m).astype(np.float32), rng.standard_normal(m).astype(np.float32)
    jfn = jpal.kron_matvec_slab if which == "slab" else jpal.kron_matvec_fused
    tfn = tcuda.kron_matvec_slab if which == "slab" else tcuda.kron_matvec_fused
    _, vjp = jax.vjp(lambda f, x: jfn(f, x, interpret=True), tuple(_j(fs, jnp.float32)), jnp.asarray(v))
    jgf, jgv = vjp(jnp.asarray(g))
    tf = [t.requires_grad_() for t in _t(fs, torch.float32)]
    tv = torch.as_tensor(v).requires_grad_()
    tfn(tf, tv).backward(torch.as_tensor(g))
    assert _rel(tv.grad.numpy(), jgv) < 1e-5
    for a, b in zip(tf, jgf):
        assert _rel(a.grad.numpy(), b) < 1e-5


def test_wrappers_reject_what_they_do_not_take():
    fs = _t(_factors(np.random.default_rng(12), (4, 4)), torch.float32)
    with pytest.raises(ValueError, match="d >= 3 square"):
        tcuda.kron_matvec_slab(fs, torch.ones(16))
    with pytest.raises(ValueError, match="feasible plan"):
        tcuda.kron_matvec_fused(fs, torch.ones(16))
    with pytest.raises(ValueError, match="rows"):
        tcuda.kron_matvec_fused(fs, torch.ones(15))
