"""Kernels K4 (interp_wt) and K5 (wtw_stencil) on the card, and SKI's
operators through them.

Marked ``cuda``; without a CUDA device every test skips.  On a GPU machine
without jax run ``python -m pytest --noconftest tests/test_torch_interp_cuda.py``
(``tests/conftest.py`` imports jax; this file does not).  Tolerances: float32
against the plain version 1e-6 of the output scale (both sum the same short
products, in another order and with fused multiply-adds); float64 1e-12.
"""

import math

import numpy as np
import pytest
import torch

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.ops import interp as tint
from gp_grief_tpu_torch.ops import interp_stencil as tst
from gp_grief_tpu_torch.ops.cuda import _build, interp as k4, interp_wt, kron as tk, stencil as k5, wtw_stencil
from gp_grief_tpu_torch.ops.kron_fast import batch_identity, kernel_route, kron_matvec_fast

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _geometry(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    xg = [np.sort(rng.uniform(0, 1, m)) for m in shape]
    x = rng.uniform(-0.1, 1.1, size=(n, len(shape)))
    return tint.interp_weights(x, xg)


CASES = [((7, 5, 6), 400), ((12, 9, 10), 5000), ((32, 32, 32), 3000), ((16, 16, 16, 16), 20000)]


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,n", CASES)
def test_interp_wt_matches_plain_version_and_repeats_bits(cuda, shape, n, dtype):
    iw = _geometry(shape, n)
    plan = tint.build_interp_plan(iw, dtype=dtype, device=cuda)
    u = torch.randn((9, n), generator=torch.Generator().manual_seed(1), dtype=torch.float64).to(cuda, dtype)
    before = interp_wt.launches
    got = interp_wt(plan, u)
    again = interp_wt(plan, u)
    torch.cuda.synchronize()
    assert interp_wt.launches == before + 2
    assert got.shape == (9, math.prod(shape)) and torch.equal(got, again)
    assert _rel(got, tint.interp_rmatvec_bm_exact(plan, u)) <= TOL[dtype]


def _stress_geometry(which):
    """K4's redesign under stress: n >> M (about 30 entries a cell); a slab
    of points that puts up to ~180 entries in each of ~230 cells (over the
    warp threshold, and a block's stream range three times the largest
    shared-memory chunk) among many empty ones; a sparse scatter that leaves
    most cells empty."""
    rng = np.random.default_rng(11)
    if which == "dense":
        return _geometry((16, 16, 16, 16), 200_000, seed=11)
    if which == "sparse":
        return _geometry((24, 20, 22), 1500, seed=12)
    xg = [np.linspace(0, 1, m) for m in (20, 18, 16)]
    slab = np.stack([0.5 + 0.01 * rng.uniform(-1, 1, 4000), rng.uniform(0.3, 0.7, 4000), rng.uniform(0, 1, 4000)], 1)
    return tint.interp_weights(np.concatenate([slab, rng.uniform(0, 1, (300, 3))]), xg)


@pytest.mark.parametrize("B", [1, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["dense", "clustered", "sparse"])
def test_interp_wt_under_stress(cuda, which, dtype, B):
    iw = _stress_geometry(which)
    plan = tint.build_interp_plan(iw, dtype=dtype, device=cuda)
    lengths = (plan.end_ptr - plan.start_ptr).long()
    if which == "clustered":
        block_ranges = plan.end_ptr.long()[255::256] - plan.start_ptr.long()[::256][: plan.M // 256]
        assert int((lengths > 64).sum()) > 200 and int((lengths == 0).sum()) > plan.M // 2
        assert int(block_ranges.max()) > 3 * 5120  # the largest chunk: float32, one row
    n = plan.n
    u = torch.randn((B, n), generator=torch.Generator().manual_seed(B), dtype=torch.float64).to(cuda, dtype)
    before = interp_wt.launches
    got = k4._launch(plan, u)
    again = k4._launch(plan, u)
    torch.cuda.synchronize()
    assert interp_wt.launches == before + 2
    assert got.shape == (B, plan.M) and torch.equal(got, again)
    # The plain version in float64 on the same operands: sums of up to ~180
    # terms round in float32 by more than the short sums TOL was set for, in
    # the plain version's own order as in the kernel's.
    plan64 = plan._replace(w_sorted=plan.w_sorted.double(), slot_w=plan.slot_w.double(), ov_w=plan.ov_w.double())
    assert _rel(got, tint.interp_rmatvec_bm_exact(plan64, u.double())) <= TOL[dtype]
    # The public entry launches the same kernel: the same bits.
    assert torch.equal(got, interp_wt(plan, u))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,n", CASES)
def test_wtw_stencil_matches_plain_version_and_repeats_bits(cuda, shape, n, dtype):
    st = tst.build_wtw_stencil(_geometry(shape, n, seed=2), dtype=dtype, device=cuda)
    v = torch.randn((20, st.M), generator=torch.Generator().manual_seed(3), dtype=torch.float64).to(cuda, dtype)
    before = wtw_stencil.launches
    got = wtw_stencil(st, v)
    again = wtw_stencil(st, v)
    torch.cuda.synchronize()
    assert wtw_stencil.launches == before + 2
    assert torch.equal(got, again)
    assert _rel(got, tst.stencil_apply_ref(st, v)) <= TOL[dtype]


# (shape, n, B): K5's members on a size-1 extent, d = 1 and d = 5, at the
# batches the lattice dual (9), two slabs (17), one row (1) and a predict
# chunk's several slabs (130) give it.
MEMBER_CASES = [((7, 5, 6), 400, 9), ((12, 9, 10), 5000, 17), ((16, 16, 16, 16), 20000, 1),
                ((16, 16, 16, 16), 20000, 130), ((20, 1, 30), 2000, 9), ((3000,), 500, 9),
                ((10, 10, 10, 10, 10), 20000, 9), ((10, 10, 10, 10, 10), 20000, 16), ((32, 32, 32), 3000, 17)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,n,B", MEMBER_CASES)
def test_wtw_stencil_members_match_plain_version_and_each_other(cuda, shape, n, B, dtype):
    """The plan's member, the cell member and (where the plan picks the
    window member) the window member with one buffer give the same bits,
    each twice, and match the plain version."""
    st = tst.build_wtw_stencil(_geometry(shape, n, seed=6), dtype=dtype, device=cuda)
    v = torch.randn((B, st.M), generator=torch.Generator().manual_seed(7), dtype=torch.float64).to(cuda, dtype)
    plan = k5._cached_plan(st, B, v.element_size())[0]
    plans = [plan, k5.StencilPlan("cell", k5.MAX_ROWS, -(-B // k5.MAX_ROWS))]
    if plan.member == "window" and plan.buffers == 2:
        plans.append(plan._replace(buffers=1))
    ref = tst.stencil_apply_ref(st, v)
    outs = []
    for pl in plans:
        before = wtw_stencil.launches
        got = k5._launch(st, v, pl)
        again = k5._launch(st, v, pl)
        torch.cuda.synchronize()
        assert wtw_stencil.launches == before + 2
        assert got.shape == (B, st.M) and torch.equal(got, again), pl
        assert _rel(got, ref) <= TOL[dtype], pl
        outs.append(got)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    # The public entry point runs the plan's member, made once and kept on the stencil.
    assert torch.equal(wtw_stencil(st, v), outs[0])
    assert list(st.plans) == [(B, v.element_size())] and st.plans[(B, v.element_size())][0] == plan


def test_wtw_stencil_plan_reaches_both_members(cuda):
    """d = 5 on 10^5 cells: float32 at B = 9 gets the window member; float64
    at 16 rows a slab has no window that fits and gets the cell member."""
    iw = _geometry((10,) * 5, 20000, seed=6)
    members = {}
    for dtype, B in ((torch.float32, 9), (torch.float64, 16)):
        st = tst.build_wtw_stencil(iw, dtype=dtype, device=cuda)
        members[dtype] = k5._cached_plan(st, B, st.tables.element_size())[0].member
    assert members == {torch.float32: "window", torch.float64: "cell"}


def test_kernels_differentiate(cuda):
    iw = _geometry((6, 5, 4), 200)
    plan = tint.build_interp_plan(iw, dtype=torch.float64, device=cuda)
    u = torch.randn((3, 200), dtype=torch.float64, device=cuda, requires_grad=True)
    c = torch.randn((3, 120), dtype=torch.float64, device=cuda)
    (g,) = torch.autograd.grad(torch.sum(interp_wt(plan, u) * c), u)
    assert _rel(g, tint.interp_matvec_bm_fast(plan, c)) <= 1e-12
    st = tst.build_wtw_stencil(iw, dtype=torch.float64, device=cuda)
    v = torch.randn((2, 120), dtype=torch.float64, device=cuda, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(wtw_stencil(st, v) * c[:2]), v)
    assert _rel(g, tst.stencil_apply_ref(st, c[:2])) <= 1e-12


def test_build_or_launch_failure_raises(cuda, monkeypatch):
    iw = _geometry((6, 5, 4), 200)
    plan = tint.build_interp_plan(iw, dtype=torch.float32, device=cuda)
    st = tst.build_wtw_stencil(iw, dtype=torch.float32, device=cuda)
    u = torch.zeros((2, 200), device=cuda)
    v = torch.zeros((2, 120), device=cuda)

    def no_build():
        raise RuntimeError("nvcc failed with exit code 1")

    monkeypatch.setattr(_build, "load_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        interp_wt(plan, u)
    with pytest.raises(RuntimeError, match="nvcc"):
        wtw_stencil(st, v)

    class Refusing:  # every entry point reports cudaErrorInvalidConfiguration
        def __getattr__(self, name):
            return lambda *args: 9

    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    before = (interp_wt.launches, wtw_stencil.launches)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        interp_wt(plan, u)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        wtw_stencil(st, v)
    assert (interp_wt.launches, wtw_stencil.launches) == before
    with pytest.raises(TypeError, match="float32 or float64"):
        interp_wt(plan, u.half())


def test_leading_identity_batches_route_and_compute(cuda):
    """SKI folds the batch in as a leading ``batch_identity``.  At 32^4 the
    1 + 8 probe rows (B = 9, which the copied slab gate refuses: 128 % 9),
    the 8 SLQ rows and the 16- and 31-probe solves (17, 32 rows) take K2 at
    the X3 preset, for a float32 and a bf16 vector alike, the identity
    folded into the plan's rows: the planned
    passes of 32^4 and none over the identity.  K2 agrees with its plain
    version (and the float32 vector with float64); so does the rank-256
    LOVE basis, (I_256, 32^4) "highest", which the gate also sends to K2."""
    g = torch.Generator().manual_seed(4)
    Qs = [torch.linalg.qr(torch.randn((32, 32), generator=g))[0].contiguous().to(cuda) for _ in range(4)]
    passes = len(tk._hopper_plan([32] * 4, [32] * 4, 1))
    for B in (9, 8, 17, 32):
        fs = (batch_identity(B, device=cuda), *Qs)
        for vdtype in (torch.float32, torch.bfloat16):
            assert kernel_route(fs, 1, "BF16_BF16_F32_X3", vector_dtype=vdtype) == "slab"
            v = torch.randn((B * 32**4,), generator=g).to(cuda, vdtype)
            before = tk.kron_matvec_slab.launches
            got = kron_matvec_fast(fs, v, precision="BF16_BF16_F32_X3")
            torch.cuda.synchronize()
            assert tk.kron_matvec_slab.launches - before == passes
            assert got.dtype == vdtype and got.shape == v.shape
            fast = vdtype == torch.bfloat16
            plain = tk.kron_chain_ref(fs, v.float()[:, None], fast=fast)[:, 0]
            assert _rel(got.float(), plain) < (1e-2 if fast else 1e-5)
            if not fast:
                exact = tk.kron_chain_ref([f.double() for f in fs], v.double()[:, None])[:, 0]
                assert _rel(got, exact) < 1e-5
    # LOVE's basis at rank 256 (models/gp_ski.py:795), "highest": the gate's
    # exact tile class sends it to K2 (8.6x the chain on an H100).
    fs = (batch_identity(256, device=cuda), *Qs)
    assert kernel_route(fs, 1, "highest") == "slab"
    v = torch.randn((256 * 32**4,), generator=g).to(cuda)
    before = tk.kron_matvec_slab.launches
    got = kron_matvec_fast(fs, v, precision="highest")
    torch.cuda.synchronize()
    assert tk.kron_matvec_slab.launches - before == passes
    assert _rel(got, tk.kron_chain_ref(fs, v[:, None])[:, 0]) < 1e-5


@pytest.mark.parametrize("solver", ["data", "lattice"])
def test_ski_model_on_the_card_matches_the_cpu(cuda, solver):
    """float64 NLML and predictions of a small SKI model on the card (K4, K5)
    and on the CPU (their plain versions), on probes drawn on the CPU and
    copied to the card.  The NLML to 1e-10; predictions to 1e-8 (their CG
    solves stop at cg_tol = 1e-10, and the two devices' rounding moves the
    stopping point: 2.2e-9 measured on the lattice solver)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 3, (600, 3))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.3 * x[:, 2] + 0.05 * rng.standard_normal(600)
    xg = [np.linspace(-0.1, 3.1, m)[:, None] for m in (8, 7, 6)]
    xs = rng.uniform(0.2, 2.8, (30, 3))
    kw = dict(noise_var=0.2, num_probes=4, lanczos_iters=15, cg_tol=1e-10, solver=solver, precond_rank=16)
    kerns = [gpt.make_kernel("rbf", lengthscale=ls) for ls in (0.8, 0.9, 1.1)]
    import gp_grief_tpu_torch.ops.lanczos as tlz

    draw = tlz.rademacher

    def cpu_draw(shape, *, dtype, device, generator):
        return draw(shape, dtype=dtype, device="cpu", generator=torch.Generator().manual_seed(7)).to(device)

    tlz.rademacher = cpu_draw
    try:
        out = {}
        for dev in ("cpu", cuda):
            m = gpt.GPSKIRegression(x, y, kerns, xg, device=dev, **kw)
            k4, k5 = interp_wt.launches, wtw_stencil.launches
            ll = m.log_likelihood()
            if dev != "cpu":
                assert interp_wt.launches > k4
                assert (wtw_stencil.launches > k5) == (solver == "lattice")
            mean, var = m.predict(xs, chunk=8)
            out[str(dev)] = (ll, mean.cpu().numpy(), var.cpu().numpy())
    finally:
        tlz.rademacher = draw
    (lc, mc, vc), (lg, mg, vg) = out["cpu"], out[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-10)
    np.testing.assert_allclose(mg, mc, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(vg, vc, rtol=1e-8, atol=1e-12)
