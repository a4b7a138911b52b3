"""``GPSKIRegression``'s training against the JAX package's, float64 on the
CPU, on the same NumPy inputs (n = 400 points in 3-D, a 6×7×5 grid).

The ``probes`` fixture hands both packages the same NumPy Rademacher probes
in call order, with the JAX side's eigen-conventions
(``tools/ski_reference_jax.py``), as in ``test_torch_ski.py``.  The JAX
models take the exact ELL interpolation transpose (``_oplan = None``)
instead of the one-hot Pallas kernel, which runs in interpret mode off a
TPU: the same sums in another order.

Tolerances, each beside the gap measured here: the BBMM surrogate gradients
against ``jax.grad(model._loss)``, ≤ 3.8e-12 relative, held at 1e-9 (both
CGs stop at 1e-10); one ``optimize_segmented`` step's solves ≤ 1.6e-12 and
its surrogate value and gradient ≤ 4e-15 with the solves injected, held at
1e-9.
"""

import warnings

import numpy as np
import pytest
import torch

import chip_smoke as cs
import gp_grief_tpu as gpx
import gp_grief_tpu.models.gp_ski as jski
import gp_grief_tpu_torch as gpt
import gp_grief_tpu_torch.ops.lanczos as tlz
import jax
from gp_grief_tpu_torch.ops.cuda.interp import interp_w, interp_wt
from gp_grief_tpu_torch.ops.interp import build_interp_plan, interp_expand, interp_weights, iw_to_torch
from tools import ski_reference_jax as ref

torch.set_num_threads(1)

RTOL = 1e-9
LENGTHSCALES = (0.8, 0.9, 1.1)  # unequal: no exactly tied eigenvalue products
CASES = {
    "data_rank0": dict(solver="data", precond_rank=0),
    "data_rank12": dict(solver="data", precond_rank=12),
    "lattice_stencil": dict(solver="lattice", wtw_stencil=True),
    "lattice_no_stencil": dict(solver="lattice", wtw_stencil=False),
}


@pytest.fixture
def probes(monkeypatch):
    jp, tp = ref.NumpyProbes(), cs.NumpyProbes()
    monkeypatch.setattr(jax.random, "rademacher", jp)
    monkeypatch.setattr(jski, "kron_eigh", ref.kron_eigh_canonical)
    monkeypatch.setattr(jski, "top_p_kron_eigs", ref.top_p_kron_eigs_quantized)
    monkeypatch.setattr(tlz, "rademacher", tp)
    return jp, tp


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 3, (n, 3))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.3 * x[:, 2] + 0.05 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 3.1, m)[:, None] for m in (6, 7, 5)]
    return x, y, xg


def _pair(jax_model=True, **kw):
    x, y, xg = _data()
    args = dict(dict(noise_var=0.2, num_probes=4, lanczos_iters=12, cg_iters=200, cg_tol=1e-10), **kw)
    jm = None
    if jax_model:
        jargs = {k: v for k, v in args.items() if k != "train_mixed16" or v}
        jm = gpx.GPSKIRegression(x, y, [gpx.make_kernel("rbf", lengthscale=ls) for ls in LENGTHSCALES], xg,
                                 **jargs)
        jm._oplan = None
        jm._wplan = None
    tm = gpt.GPSKIRegression(x, y, [gpt.make_kernel("rbf", lengthscale=ls) for ls in LENGTHSCALES], xg,
                             device="cpu", **args)
    return jm, tm


def _flat_grad(model):
    return np.concatenate([p.grad.numpy().ravel() for _, p in model._leaves()])


def _jax_flat(tree):
    return np.concatenate([np.ravel(g) for g in jax.tree_util.tree_leaves(tree)])


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_loss_gradient_matches_jax(probes, case):
    """``_loss`` / ``_loss_lattice``: value and BBMM surrogate gradient
    against ``jax.value_and_grad`` of the JAX package's, the same probes."""
    jm, tm = _pair(**CASES[case])
    probes[0].calls = probes[1].calls = 0
    vj, gj = jax.value_and_grad(jm._loss)(jm.params)
    tm.zero_grad()
    vt = tm._loss()
    vt.backward()
    assert probes[0].calls == probes[1].calls == 2
    assert float(vt.detach()) == pytest.approx(float(vj), rel=RTOL)
    assert _rel(_flat_grad(tm), _jax_flat(gj)) <= RTOL
    # The surrogate leaves the value where log_likelihood() puts it.
    probes[1].calls = 0
    assert -float(vt.detach()) == pytest.approx(tm.log_likelihood(), rel=1e-13)


@pytest.mark.parametrize("case", ["data_rank12", "lattice_stencil"])
def test_optimize_segmented_step_matches_jax(probes, monkeypatch, case):
    """One step of ``optimize_segmented``: the JAX package's segmented step
    solves against the port's on the probes the JAX step drew, then the
    surrogate value and gradient with those solves injected into both
    packages."""
    R, seg = 3, 20
    jm, tm = _pair(**CASES[case])
    jsol, jz = jm._segmented_step_solves(jm.params, jax.random.PRNGKey(0), R, seg)
    jsol, jz = np.asarray(jsol), np.asarray(jz)
    monkeypatch.setattr(tlz, "rademacher", lambda shape, **kw: torch.tensor(jz))
    tsol, tz, iters = tm._step_solves(tm._generator(0), R, seg)
    assert torch.equal(tz, torch.tensor(jz)) and iters % seg == 0 and iters > 0
    assert _rel(tsol.numpy(), jsol) <= RTOL
    jm.optimize_segmented(max_iters=0, num_probes=R)  # builds the JAX surrogate program
    vg, consts = jm._segvg
    vj, gj = vg(consts, jm.params, jsol, jz)
    tm.zero_grad()
    vt = tm._step_objective(torch.tensor(jsol), torch.tensor(jz))
    vt.backward()
    assert float(vt.detach()) == pytest.approx(float(vj), rel=RTOL)
    assert _rel(_flat_grad(tm), _jax_flat(gj)) <= RTOL


def test_train_mixed16_gradient_is_near_the_exact_one(monkeypatch):
    """The lattice dual's bf16 training solves stagnate near 3.6e-3 relative
    (the JAX package's measurement at 1M/32⁴); the surrogate gradient built
    on them is held to the float64 solves' within that floor, 5e-3 relative
    to its largest component (measured here: 4.6e-4)."""
    z = torch.as_tensor(cs.ski_probe(0, (4, 6 * 7 * 5)))
    monkeypatch.setattr(tlz, "rademacher", lambda shape, **kw: z)
    grads = {}
    for mixed in (False, True):
        _, tm = _pair(jax_model=False, solver="lattice", train_mixed16=mixed)
        sol, _, iters = tm._step_solves(tm._generator(0), 4, 10)
        tm.zero_grad()
        tm._step_objective(sol, z).backward()
        grads[mixed] = _flat_grad(tm)
    assert _rel(grads[True], grads[False]) <= 5e-3


@pytest.mark.parametrize("solver", ["data", "lattice"])
def test_log_likelihood_segmented_matches_log_likelihood(monkeypatch, solver):
    """With one chunk of the same probes the fused driver's estimate is
    ``log_likelihood()``'s to the CG tolerance (measured ≤ 5e-16 relative,
    held at 1e-9), fused or not (≤ 4.9e-16).  In chunks of 2, other probes
    move it within the SLQ sampling error of 4 probes (measured 3.0e-3 for
    the data solver, 2.1e-2 for the lattice dual; held at 5e-2)."""
    fixed = {}

    def draw(shape, **kw):
        return fixed.setdefault(tuple(shape), torch.as_tensor(cs.ski_probe(len(fixed), tuple(shape))))

    monkeypatch.setattr(tlz, "rademacher", draw)
    _, tm = _pair(jax_model=False, solver=solver, precond_rank=12)
    ll = tm.log_likelihood()
    same = tm.log_likelihood_segmented(probe_chunk=4, cg_segment_iters=20)
    assert same == pytest.approx(ll, rel=RTOL) and tm.cg_iterations > 0
    fused = tm.log_likelihood_segmented(probe_chunk=2)
    assert tm.log_likelihood_segmented(probe_chunk=2, fuse_probes=False) == pytest.approx(fused, rel=RTOL)
    assert fused == pytest.approx(ll, rel=5e-2)


def test_interp_w_backward_is_the_dense_transpose():
    """``interp_w``'s backward (``Wᵀ``, K4's plain version on the CPU) against
    the dense ``Wᵀ``; no kernel launches on the CPU."""
    x, _, xg = _data(n=50)
    iw = interp_weights(x, xg)
    plan = build_interp_plan(iw, dtype=torch.float64, device="cpu")
    W = interp_expand(iw_to_torch(iw, dtype=torch.float64, device="cpu")).numpy()  # (n, M)
    rng = np.random.default_rng(1)
    v = torch.tensor(rng.standard_normal((3, W.shape[1])), requires_grad=True)
    g = rng.standard_normal((3, W.shape[0]))
    before = interp_wt.launches
    out = interp_w(plan, v)
    np.testing.assert_allclose(out.detach().numpy(), v.detach().numpy() @ W.T, rtol=1e-13, atol=1e-13)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(v.grad.numpy(), g @ W, rtol=1e-13, atol=1e-13)
    assert interp_wt.launches == before
    with pytest.raises(ValueError, match="interp_w"):
        interp_w(plan, v[:, :-1])


@pytest.mark.parametrize("solver", ["data", "lattice"])
def test_training_lowers_the_nlml_and_repeats(solver):
    """Three ``optimize_segmented`` steps from the same start twice: the same
    bits both times, and a lower NLML (the same probes) than at the start."""
    runs = []
    for _ in range(2):
        _, tm = _pair(jax_model=False, solver=solver, precond_rank=12, noise_var=1.0)
        before = tm.log_likelihood()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res = tm.optimize_segmented(max_iters=3, learning_rate=0.1, num_probes=4, cg_segment_iters=20)
        runs.append((before, tm.log_likelihood(), res.losses, tm.parameters))
    (b0, a0, l0, p0), (_, a1, l1, p1) = runs
    assert a0 > b0 and np.array_equal(l0, l1) and np.array_equal(p0, p1) and a0 == a1
    assert len(l0) == 3 and np.all(np.isfinite(l0))
