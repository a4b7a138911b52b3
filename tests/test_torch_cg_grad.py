"""The CG implicit gradient (``ops.cg``): ``cg_solve`` and ``cg_solve_refined``
differentiated through one more solve, float64 on the CPU.

The system is ``(K₁ ⊗ K₂ ⊗ K₃ + σ²I) x = b`` on a 5×6×7 lattice (κ ≈ 600),
with ``K₁`` and ``b`` the differentiated inputs.  Each gradient is held to
``torch.linalg.solve``'s autograd on the dense matrix and to ``jax.grad`` of
the JAX package's solver on the same NumPy inputs.  The solves stop at a
relative residual of 1e-12, so both gradients are exact to ~κ·1e-12: the
measured gaps are ≤ 7.2e-13 relative (against the dense solve) and ≤ 3.5e-13
(against JAX's), held at 1e-9 and 1e-10.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gp_grief_tpu.ops import cg as jcg
from gp_grief_tpu.ops import kron as jkron
from gp_grief_tpu_torch.ops import cg as tcg
from gp_grief_tpu_torch.ops import kron as tkron

torch.set_num_threads(1)

SIZES = (5, 6, 7)
SIGMA2 = 0.05
TOL = 1e-12
DENSE_RTOL = 1e-9
JAX_RTOL = 1e-10


def _inputs(layout):
    rng = np.random.default_rng(3)
    Ks = []
    for m in SIZES:
        x = np.sort(rng.uniform(0, 3, m))
        Ks.append(np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.6) ** 2))
    M = math.prod(SIZES)
    b = rng.standard_normal((M, 3))
    w = rng.standard_normal((M, 3))  # the loss is Σ w ⊙ x
    x0 = 0.1 * rng.standard_normal((M, 3))
    if layout == "bm":
        b, w, x0 = b.T.copy(), w.T.copy(), x0.T.copy()
    return Ks, b, w, x0


def _mv(kron_matvec, Ks, layout):
    """``A v`` for columns ``(M, B)`` or rows ``(B, M)``."""
    if layout == "col":
        return lambda v: kron_matvec(Ks, v) + SIGMA2 * v
    return lambda v: kron_matvec(Ks, v.T).T + SIGMA2 * v


def _jacobi(Ks, layout, xp):
    """A diagonal preconditioner (it must not change the gradient)."""
    d = 1.0
    for K in Ks:
        d = np.kron(d, np.diag(np.asarray(K)))
    inv = xp.asarray(1.0 / (d + SIGMA2))
    return (lambda r: inv[:, None] * r) if layout == "col" else (lambda r: inv[None, :] * r)


def _dense_grads(Ks, b, w, layout):
    K0 = torch.tensor(Ks[0], requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    A = torch.kron(torch.kron(K0, torch.as_tensor(Ks[1])), torch.as_tensor(Ks[2]))
    A = A + SIGMA2 * torch.eye(A.shape[0], dtype=A.dtype)
    rhs = bt if layout == "col" else bt.T
    x = torch.linalg.solve(A, rhs)
    x = x if layout == "col" else x.T
    torch.sum(torch.as_tensor(w) * x).backward()
    return K0.grad.numpy(), bt.grad.numpy()


def _port_grads(Ks, b, w, x0, layout, variant, refined):
    K0 = torch.tensor(Ks[0], requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    tK = [K0] + [torch.as_tensor(k) for k in Ks[1:]]
    mv = _mv(tkron.kron_matvec, tK, layout)
    M_inv = _jacobi(Ks, layout, torch) if variant == "precond" else None
    if refined:
        # The fast operator rounds its input to float32; it carries no gradient.
        fast = _mv(tkron.kron_matvec, [k.detach() for k in tK], layout)
        x = tcg.cg_solve_refined(lambda v: fast(v.float().double()), mv, bt, tol=TOL, inner_iters=30,
                                 max_restarts=20, M_inv=M_inv, layout=layout)
    else:
        x0t = torch.as_tensor(x0) if variant == "x0" else None
        x = tcg.cg_solve(mv, bt, x0=x0t, tol=TOL, max_iters=2000, M_inv=M_inv, layout=layout)
    torch.sum(torch.as_tensor(w) * x).backward()
    return K0.grad.numpy(), bt.grad.numpy()


def _jax_grads(Ks, b, w, x0, layout, variant, refined):
    M_inv = _jacobi(Ks, layout, jnp) if variant == "precond" else None

    def loss(K0, bb):
        jK = [K0] + [jnp.asarray(k) for k in Ks[1:]]
        mv = _mv(jkron.kron_matvec, jK, layout)
        if refined:
            fast = _mv(jkron.kron_matvec, [jax.lax.stop_gradient(k) for k in jK], layout)
            x = jcg.cg_solve_refined(lambda v: fast(v.astype(jnp.float32).astype(jnp.float64)), mv, bb, tol=TOL,
                                     inner_iters=30, max_restarts=20, M_inv=M_inv, layout=layout)
        else:
            x = jcg.cg_solve(mv, bb, x0=jnp.asarray(x0) if variant == "x0" else None, tol=TOL, max_iters=2000,
                             M_inv=M_inv, layout=layout)
        return jnp.sum(jnp.asarray(w) * x)

    gK, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(Ks[0]), jnp.asarray(b))
    return np.asarray(gK), np.asarray(gb)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# cg_solve_refined takes no starting point.
CASES = [("cg_solve", v) for v in ("plain", "x0", "precond")] + [("cg_solve_refined", v) for v in ("plain", "precond")]


@pytest.mark.parametrize("layout", ["col", "bm"])
@pytest.mark.parametrize("solver,variant", CASES)
def test_gradients_match_dense_solve_and_jax(solver, variant, layout):
    refined = solver == "cg_solve_refined"
    Ks, b, w, x0 = _inputs(layout)
    got = _port_grads(Ks, b, w, x0, layout, variant, refined)
    for g, want in zip(got, _dense_grads(Ks, b, w, layout)):
        assert _rel(g, want) <= DENSE_RTOL
    for g, want in zip(got, _jax_grads(Ks, b, w, x0, layout, variant, refined)):
        assert _rel(g, want) <= JAX_RTOL


@pytest.mark.parametrize("refined", [False, True], ids=["cg_solve", "cg_solve_refined"])
def test_values_keep_the_value_solves_bits(refined):
    """With a gradient attached, the solution is the value solve's, bit for
    bit, and so is the info; a solve with nothing to differentiate returns
    the value solve's tensor unchanged."""
    Ks, b, _, _ = _inputs("bm")
    K0 = torch.tensor(Ks[0], requires_grad=True)
    tK = [K0] + [torch.as_tensor(k) for k in Ks[1:]]
    mv = _mv(tkron.kron_matvec, tK, "bm")
    bt = torch.as_tensor(b)

    def solve(**kw):
        if refined:
            return tcg.cg_solve_refined(mv, mv, bt, tol=1e-8, layout="bm", return_info=True, **kw)
        return tcg.cg_solve(mv, bt, tol=1e-8, layout="bm", return_info=True, **kw)

    x, info = solve()
    assert x.requires_grad
    with torch.no_grad():
        xv, infov = solve(implicit_diff=False)
    assert torch.equal(x.detach(), xv) and info.iterations == infov.iterations
    assert torch.equal(info.residual_norm, infov.residual_norm)
    K0.requires_grad_(False)
    xn, _ = solve()
    assert not xn.requires_grad and torch.equal(xn, xv)


def test_fixed_iterations_differentiate_through_a_fixed_adjoint():
    """``fixed_iters`` runs the adjoint for the same count: at a count that
    converges, the gradient is the dense solve's."""
    Ks, b, w, _ = _inputs("col")
    bt = torch.tensor(b, requires_grad=True)
    mv = _mv(tkron.kron_matvec, [torch.as_tensor(k) for k in Ks], "col")
    x = tcg.cg_solve(mv, bt, fixed_iters=400)
    torch.sum(torch.as_tensor(w) * x).backward()
    assert _rel(bt.grad.numpy(), _dense_grads(Ks, b, w, "col")[1]) <= DENSE_RTOL
