"""The plain versions of kernels K6, K7 and K8 against the JAX package's
Pallas kernels in interpret mode, on the CPU.

The entry points ``kron_matmat_cuda`` (K7), ``last_slab_pass`` (K6) and
``tail3_pass`` / ``tail2_pass`` (K8) run their plain versions on CPU tensors;
the same NumPy float32 inputs go through ``kron_matmat_pallas``,
``last_slab_pass``, ``_tail3_pass`` and ``_tail2_pass`` with
``interpret=True``, at the shapes of tests/test_pallas.py and
tests/test_kron_fast.py.  Tolerances are relative Frobenius norms:

* 1e-5 at the exact grade: both sides are float32 with float32 accumulation
  and differ by summation order only (measured ≤ 4e-7);
* 2e-2 at ``"default"``: the port's plain version rounds every operand to
  bf16 (the kernels' fast grade), while XLA's CPU dot ignores DEFAULT and
  stays float32, so the two sit in the bf16 class of each other (as
  tests/test_torch_kron.py holds K2 and K3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_grief_tpu.ops.pallas import kron_pallas as jpal
from gp_grief_tpu_torch.ops import kron as tkron
from gp_grief_tpu_torch.ops.cuda import kron_axes as ka

torch.set_num_threads(1)

EXACT_TOL = 1e-5
FAST_TOL = 2e-2
JAX_PREC = {"highest": jax.lax.Precision.HIGHEST, "default": jax.lax.Precision.DEFAULT}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _mats(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _exact(fs, v):
    """(⊗ fs) · v in float64."""
    return tkron.kron_matvec([torch.as_tensor(f, dtype=torch.float64) for f in fs],
                             torch.as_tensor(v, dtype=torch.float64)).numpy()


@pytest.mark.parametrize("sizes,B", [
    ((4, 4, 4), 1), ((8, 4, 2), 1), ((2, 2, 2, 2, 2), 1), ((16, 16), 1), ((4, 4, 4), 5), ((8, 8), 3),
])
def test_kron_matmat_matches_jax_interpret(sizes, B):
    """K7 at the six cases of tests/test_pallas.py (unscaled factors)."""
    rng = np.random.default_rng(0)
    fs = _mats(rng, [(m, m) for m in sizes])
    v = rng.standard_normal((math.prod(sizes), B)).astype(np.float32)
    want = np.asarray(jpal.kron_matmat_pallas([jnp.asarray(f) for f in fs], jnp.asarray(v), interpret=True))
    got = ka.kron_matmat_cuda([torch.as_tensor(f) for f in fs], torch.as_tensor(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == v.shape
    assert _rel(got.numpy(), want) < EXACT_TOL
    assert _rel(got.numpy(), _exact(fs, v)) < EXACT_TOL


def test_kron_matvec_rectangular_matches_jax_interpret():
    """K7 with rectangular factors and a single vector (tests/test_pallas.py:35-43)."""
    rng = np.random.default_rng(1)
    fs = _mats(rng, [(6, 4), (3, 8)])
    v = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(jpal.kron_matvec_pallas([jnp.asarray(f) for f in fs], jnp.asarray(v), interpret=True))
    got = ka.kron_matvec_cuda([torch.as_tensor(f) for f in fs], torch.as_tensor(v))
    assert tuple(got.shape) == (18,)
    assert _rel(got.numpy(), want) < EXACT_TOL
    assert _rel(got.numpy(), _exact(fs, v)) < EXACT_TOL


def test_kron_matmat_gradient_matches_jax():
    """K7's gradients w.r.t. the factors and v against jax.grad of
    kron_matmat_pallas (tests/test_pallas.py:63-83); both backward passes are
    the exact chain's VJP."""
    rng = np.random.default_rng(2)
    fs = _mats(rng, [(m, m) for m in (4, 3, 5)])
    V = rng.standard_normal((60, 2)).astype(np.float32)
    G = rng.standard_normal((60, 2)).astype(np.float32)

    def loss(f, x):
        return jnp.sum(jpal.kron_matmat_pallas(f, x, interpret=True) * jnp.asarray(G))

    jgf, jgv = jax.grad(loss, argnums=(0, 1))(tuple(jnp.asarray(f) for f in fs), jnp.asarray(V))
    tf = [torch.as_tensor(f).requires_grad_() for f in fs]
    tv = torch.as_tensor(V).requires_grad_()
    torch.sum(ka.kron_matmat_cuda(tf, tv) * torch.as_tensor(G)).backward()
    assert _rel(tv.grad.numpy(), jgv) < EXACT_TOL
    for a, b in zip(tf, jgf):
        assert _rel(a.grad.numpy(), b) < EXACT_TOL


@pytest.mark.parametrize("N,S,So,BP", [
    (64, 8, 8, 16),   # tests/test_kron_fast.py:44-51
    (64, 8, 12, 16),  # rectangular W
    (63, 8, 12, 16),  # odd N: the JAX package sends it to one XLA matmul
])
def test_last_slab_pass_matches_jax_interpret(N, S, So, BP):
    rng = np.random.default_rng(3)
    x2, W = _mats(rng, [(N, S), (So, S)])
    want = np.asarray(jpal.last_slab_pass(jnp.asarray(x2), jnp.asarray(W), BP=BP, interpret=True))
    got = ka.last_slab_pass(torch.as_tensor(x2), torch.as_tensor(W))
    ref = ka.last_slab_pass_ref(torch.as_tensor(x2), torch.as_tensor(W))
    assert tuple(got.shape) == (N, So) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < EXACT_TOL
    assert _rel(ref.numpy(), want) < EXACT_TOL
    exact = ka.last_slab_pass_ref(torch.as_tensor(x2, dtype=torch.float64), torch.as_tensor(W, dtype=torch.float64))
    assert exact.dtype == torch.float64 and _rel(got.numpy(), exact.numpy()) < EXACT_TOL


# (x shape, factor shapes): square and rectangular (o > n on some axes).
TAIL3_CASES = [((6, 4, 5, 3), [(4, 4), (5, 5), (3, 3)]), ((4, 4, 5, 3), [(5, 4), (3, 5), (6, 3)])]
TAIL2_CASES = [((10, 6, 7), [(6, 6), (7, 7)]), ((8, 6, 7), [(9, 6), (4, 7)])]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("g,xshape,kshapes", [(3, *c) for c in TAIL3_CASES] + [(2, *c) for c in TAIL2_CASES])
def test_tail_passes_match_jax_interpret(g, xshape, kshapes, precision):
    """K8: ``tail3_pass``/``tail2_pass`` (the plain version on the CPU) and
    their ``_ref`` functions against ``_tail3_pass``/``_tail2_pass``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(xshape).astype(np.float32)
    Ks = _mats(rng, kshapes)
    jfn = jpal._tail3_pass if g == 3 else jpal._tail2_pass
    want = np.asarray(jfn(jnp.asarray(x), *[jnp.asarray(K) for K in Ks], JAX_PREC[precision], True))
    tx, tK = torch.as_tensor(x), [torch.as_tensor(K) for K in Ks]
    tfn, rfn = (ka.tail3_pass, ka.tail3_pass_ref) if g == 3 else (ka.tail2_pass, ka.tail2_pass_ref)
    got = tfn(tx, *tK, precision=precision)
    ref = rfn(tx, *tK, precision=precision)
    assert tuple(got.shape) == (xshape[0], *(k[0] for k in kshapes)) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    tol = EXACT_TOL if precision == "highest" else FAST_TOL
    assert _rel(got.numpy(), want) < tol
    exact = _exact([np.eye(xshape[0], dtype=np.float32), *Ks], x.reshape(-1)).reshape(want.shape)
    assert _rel(got.numpy(), exact) < tol
    if precision == "default":
        assert _rel(got.numpy(), exact) > 1e-5  # the fast grade's bf16 rounding is there


def test_bf16_input_takes_the_fast_grade():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((3, 4, 5)).astype(np.float32))
    Ks = [torch.as_tensor(K) for K in _mats(rng, [(4, 4), (5, 5)])]
    out = ka.tail2_pass(x.to(torch.bfloat16), *Ks)
    assert out.dtype == torch.bfloat16
    assert _rel(out.double().numpy(), ka.tail2_pass_ref(x, *Ks, precision="default").numpy()) < 1e-2
    W = Ks[1]
    slab = ka.last_slab_pass(x.reshape(12, 5).to(torch.bfloat16), W)
    assert slab.dtype == torch.bfloat16
    assert _rel(slab.double().numpy(), ka.last_slab_pass_ref(x.reshape(12, 5), W, fast=True).numpy()) < 1e-2


def test_entry_points_reject_what_they_do_not_take():
    x = torch.ones(2, 3, 4)
    K3, K4 = torch.ones(3, 3), torch.ones(4, 4)
    with pytest.raises(ValueError, match="does not match"):
        ka.tail2_pass(x, K4, K3)
    with pytest.raises(ValueError, match="does not match"):
        ka.tail3_pass(x, K3, K4, K4)
    with pytest.raises(ValueError, match="precision"):
        ka.tail2_pass(x, K3, K4, precision="fastest")
    with pytest.raises(ValueError, match="W"):
        ka.last_slab_pass(torch.ones(5, 4), torch.ones(4, 3))
    with pytest.raises(ValueError, match="rows"):
        ka.kron_matmat_cuda([K3, K4], torch.ones(11))
