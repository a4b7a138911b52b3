"""Kernel K1's wrapper on the CPU: its plain version against the JAX Pallas
kernel run in interpret mode (as tests/test_pallas.py runs it), its
gradient, its launch counter and its operand checks.  The CUDA kernel itself
is tested on the card by tests/test_torch_phi_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gp_grief_tpu.ops.pallas.phi_pallas import phi_fused_pallas
from gp_grief_tpu_torch.ops.cuda import phi_fused, phi_fused_ref

torch.set_num_threads(1)


def _operands(rng, d, n, m, p, dtype):
    """B and a scaled one-hot S, as tests/test_pallas.py builds them."""
    B = rng.standard_normal((d, n, m)).astype(dtype)
    idx = rng.integers(0, m, size=(p, d))
    scales = rng.uniform(0.5, 2.0, size=(p, d)).astype(dtype)
    S = np.zeros((d, m, p), dtype=dtype)
    for dd in range(d):
        S[dd, idx[:, dd], np.arange(p)] = scales[:, dd]
    return B, S


@pytest.mark.parametrize(
    "dtype,tol",
    # float32: the interpret-mode dot and the einsum sum in other orders
    # (one-hot S: one nonzero term per dot, so only the d-fold product rounds).
    # float64: the same, at double precision.
    [(np.float32, 1e-6), (np.float64, 1e-14)],
)
def test_plain_version_matches_pallas_interpret(dtype, tol):
    rng = np.random.default_rng(0)
    B, S = _operands(rng, 3, 32, 8, 16, dtype)
    ref = np.asarray(phi_fused_pallas(jnp.asarray(B), jnp.asarray(S), block_rows=16, interpret=True))
    before = phi_fused.launches
    got = phi_fused(torch.as_tensor(B), torch.as_tensor(S)).numpy()
    assert phi_fused.launches == before  # CPU tensors: plain version, no launch
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got, phi_fused_ref(torch.as_tensor(B), torch.as_tensor(S)).numpy())


def test_dense_operands_match_pallas_interpret():
    """Dense S (the real operand: scaled eigenvector columns), f64."""
    rng = np.random.default_rng(1)
    B = rng.uniform(0, 1, (4, 24, 6))
    S = rng.standard_normal((4, 6, 10))
    ref = np.asarray(phi_fused_pallas(jnp.asarray(B), jnp.asarray(S), block_rows=8, interpret=True))
    got = phi_fused(torch.as_tensor(B), torch.as_tensor(S)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_gradient_matches_jax_custom_vjp():
    rng = np.random.default_rng(2)
    B = rng.uniform(0, 1, (3, 20, 5))
    S = rng.standard_normal((3, 5, 7))
    G = rng.standard_normal((20, 7))
    _, vjp = jax.vjp(lambda b, s: phi_fused_pallas(b, s, block_rows=4, interpret=True),
                     jnp.asarray(B), jnp.asarray(S))
    gBj, gSj = vjp(jnp.asarray(G))
    Bt = torch.tensor(B, requires_grad=True)
    St = torch.tensor(S, requires_grad=True)
    (phi_fused(Bt, St) * torch.as_tensor(G)).sum().backward()
    np.testing.assert_allclose(Bt.grad.numpy(), np.asarray(gBj), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(St.grad.numpy(), np.asarray(gSj), rtol=1e-12, atol=1e-13)


def test_operand_checks():
    B = torch.zeros(3, 10, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not match"):
        phi_fused(B, torch.zeros(3, 5, 7, dtype=torch.float64))
    with pytest.raises(ValueError, match="do not match"):
        phi_fused(B, torch.zeros(2, 4, 7, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(d, n, m\)"):
        phi_fused(B[0], torch.zeros(4, 7, dtype=torch.float64))
    with pytest.raises(TypeError, match="dtypes differ"):
        phi_fused(B, torch.zeros(3, 4, 7, dtype=torch.float32))
