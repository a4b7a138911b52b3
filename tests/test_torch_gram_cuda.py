"""Kernels K9 (``ops.cuda.gram.gram_apply``) and K10 (``gram_grad``) on the
card: the matrix-free Gram apply in one pass and its hyperparameter
cotangents, each against float64 on the same inputs and against the slab
path it replaces.

Marked ``cuda``; without a CUDA device every test skips.  On a GPU machine
without jax run ``python -m pytest --noconftest tests/test_torch_gram_cuda.py``
(``tests/conftest.py`` imports jax; this file does not).

Errors are normwise per output: ``|y − y64|`` over ``Σ_j |k_ij| |v_bj| +
σ² |v_bi|``, the scale that rounding in the sum works on (every kernel here
is positive), ``y64`` the float64 apply of the same inputs.  K9 is held no
further off than the slab path, with room for the two paths' different
summation orders: ``1.5 × slab + 2 eps`` (at ``"default"`` the bf16
rounding of the same operands sets both errors).  K10's cotangents are held
the same way: ``|c − c64|`` over the same sums of ``|G|`` and ``|vv|``
(every term then non-negative), ``c64`` the float64 slab path's gradient at
the same inputs and hyperparameter values.
"""

import pytest
import torch

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.models import gp_regression as tgr
from gp_grief_tpu_torch.ops.cuda import gram

pytestmark = pytest.mark.cuda

KINDS = ("rbf", "exponential", "matern12", "matern32", "matern52")
N = 1237  # a multiple of no tile (row tiles 256 / 512, column tiles 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, kind, d, B, dtype, ard, n=N, seed=0):
    g = torch.Generator().manual_seed(seed + 7 * d + B)
    x = (3.0 * torch.rand((n, d), generator=g, dtype=torch.float64)).to(device, dtype)
    x[n // 2] = x[n // 3]  # two identical points: r2 = 0 exactly
    V = torch.randn((B, n), generator=g, dtype=torch.float64).to(device, dtype)
    ls = torch.linspace(0.5, 1.2, d, dtype=torch.float64) if ard else 0.7
    k = gpt.make_kernel(kind, lengthscale=ls, variance=1.3, dtype=dtype, device=device)
    return k, x, V, torch.tensor(0.3, dtype=dtype, device=device)


def _slab_apply(k, x, V, sig, precision, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(tgr, "fused_route", lambda *a: False)
        with torch.no_grad():
            return tgr.make_gram_matvec(k, x, sig, chunk=512, precision=precision)(V)


def _errors(k, x, V, sig, got):
    """Normwise error of ``got`` against the float64 apply (``"highest"``)
    of the same (rounded) inputs."""
    k64 = gpt.make_kernel(k.kind, lengthscale=k.lengthscale.detach().double(),
                          variance=float(k.variance.detach()), dtype=torch.float64, device=x.device)
    with torch.no_grad():
        x64, V64, s64 = x.double(), V.double(), sig.double()
        want = gram.gram_apply_ref(k64, x64, V64, s64)
        scale = gram.gram_apply_ref(k64, x64, V64.abs(), s64)
    return float(((got.double() - want).abs() / scale).max())


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 9, 17, 40])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_apply_is_no_further_off_than_the_slab_path(cuda, monkeypatch, kind, d, B, dtype, precision):
    k, x, V, sig = _case(cuda, kind, d, B, dtype, ard=(d + B) % 2 == 0)
    got = gram.gram_apply(k, x, V, sig, precision)
    slab = _slab_apply(k, x, V, sig, precision, monkeypatch)
    assert got.shape == V.shape and got.dtype == dtype
    e_fused, e_slab = _errors(k, x, V, sig, got), _errors(k, x, V, sig, slab)
    assert e_fused <= 1.5 * e_slab + 2 * torch.finfo(dtype).eps, (e_fused, e_slab)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_same_bits_on_every_call(cuda, dtype):
    k, x, V, sig = _case(cuda, "matern32", 2, 9, dtype, ard=True, n=20_000)
    a = gram.gram_apply(k, x, V, sig)
    assert all(torch.equal(a, gram.gram_apply(k, x, V, sig)) for _ in range(3))


def test_noise_term_folded_in(cuda):
    k, x, V, sig = _case(cuda, "rbf", 3, 9, torch.float32, ard=True)
    with_noise, without = gram.gram_apply(k, x, V, sig), gram.gram_apply(k, x, V, 0.0)
    eps = torch.finfo(torch.float32).eps
    assert torch.all((with_noise - without - sig * V).abs() <= 4 * eps * (with_noise.abs() + without.abs()))


def _leaf_cotangents(k, x, G, V):
    """``(∂L/∂var, ∂L/∂ℓ)`` of ``L = Σ G ⊙ mv(V)`` by autograd through
    ``make_gram_matvec``'s current route, from the kernel's log leaves."""
    kk = gpt.make_kernel(k.kind, lengthscale=1.0, variance=1.0, input_dim=x.shape[1], dtype=x.dtype,
                         device=x.device)
    with torch.no_grad():
        kk.log_lengthscale.copy_(torch.broadcast_to(k.log_lengthscale.detach(), (x.shape[1],)))
        kk.log_variance.copy_(k.log_variance.detach())
    L = torch.sum(G * tgr.make_gram_matvec(kk, x, 0.0, chunk=512)(V))
    g_ls, g_var = torch.autograd.grad(L, [kk.log_lengthscale, kk.log_variance])
    return (g_var.double() / kk.variance.detach().double(), g_ls.double() / kk.lengthscale.detach().double())


def _float64_cotangents(k, x, G, V):
    """The float64 slab path's ``(∂L/∂var, ∂L/∂ℓ)`` of the same (rounded)
    inputs and values, and the same sums of ``|G|`` and ``|vv|``."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tgr, "fused_route", lambda *a: False)
        k64 = gpt.make_kernel(k.kind, lengthscale=1.0, variance=1.0, input_dim=x.shape[1], dtype=torch.float64,
                              device=x.device)
        with torch.no_grad():
            k64.log_lengthscale.copy_(torch.broadcast_to(k.log_lengthscale.detach().double(), (x.shape[1],)))
            k64.log_variance.copy_(k.log_variance.detach().double())
        want = _leaf_cotangents(k64, x.double(), G.double(), V.double())
    scale = gram.gram_grad_ref(k.kind, x.double(), G.double().abs(), V.double().abs(), k64.lengthscale.detach(),
                               k64.variance.detach())
    return want, scale


def _grad_error(got, want, scale):
    return max(float((got[0].double() - want[0]).abs() / scale[0]),
               float(((got[1].double() - want[1]).abs() / scale[1]).max()))


def _cotangent_operands(device, kind, d, B, dtype, ard, n=N):
    k, x, G, _ = _case(device, kind, d, B, dtype, ard, n=n)
    V = torch.randn((B, n), generator=torch.Generator().manual_seed(B + 3 * d), dtype=torch.float64).to(device, dtype)
    ls = torch.broadcast_to(k.lengthscale.detach(), (d,))
    return k, x, G, V, ls, k.variance.detach()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 4, 9, 17])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_grad_is_no_further_off_than_the_slab_path(cuda, monkeypatch, kind, d, B, dtype):
    k, x, G, V, ls, var = _cotangent_operands(cuda, kind, d, B, dtype, ard=(d + B) % 2 == 0)
    got = gram.gram_grad(kind, x, G, V, ls, var)
    assert got[0].dtype == got[1].dtype == dtype and got[1].shape == (d,)
    plain = gram.gram_grad_ref(kind, x, G, V, ls, var)
    with monkeypatch.context() as m:
        m.setattr(tgr, "fused_route", lambda *a: False)
        slab = _leaf_cotangents(k, x, G, V)
    want, scale = _float64_cotangents(k, x, G, V)
    e_fused, e_plain, e_slab = (_grad_error(c, want, scale) for c in (got, plain, slab))
    eps = torch.finfo(dtype).eps
    assert e_fused <= 1.5 * e_slab + 2 * eps, (e_fused, e_slab)
    assert e_fused <= 1.5 * e_plain + 2 * eps, (e_fused, e_plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fused_grad_same_bits_on_every_call(cuda, dtype):
    k, x, G, V, ls, var = _cotangent_operands(cuda, "matern32", 2, 4, dtype, ard=True, n=20_000)
    a = gram.gram_grad("matern32", x, G, V, ls, var)
    for _ in range(3):
        b = gram.gram_grad("matern32", x, G, V, ls, var)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_make_gram_matvec_routes_the_solver_role(cuda):
    k, x, V, sig = _case(cuda, "rbf", 2, 9, torch.float32, ard=True)
    mv = tgr.make_gram_matvec(k, x, sig, chunk=512)
    before = gram.gram_apply.launches
    with torch.no_grad():
        out = mv(V)
    assert gram.gram_apply.launches == before + 1
    assert torch.equal(out, gram.gram_apply(k, x, V, sig))
    grads = gram.gram_grad.launches
    mv(V).sum().backward()  # the differentiated role: K9's forward, then K10
    assert gram.gram_apply.launches == before + 3 and gram.gram_grad.launches == grads + 1


def test_a_training_step_on_each_route_agrees(cuda, monkeypatch):
    """One ``optimize_segmented`` step at n = 8,192 on each route (K9 and
    K10, three K10 calls: the quadratic piece and two probe chunks; the slab
    path): the loss and the gradient within the benchmark's gp40k limits of each other
    (loss 5e-5 relative, each leaf's gradient 3e-3 of the larger of its
    norm and the median leaf's)."""
    g = torch.Generator().manual_seed(3)
    n = 8192
    x = 8.0 * torch.rand((n, 2), generator=g, dtype=torch.float64)
    y = torch.sin(x[:, 0]) * torch.cos(0.7 * x[:, 1]) + 0.1 * torch.randn(n, generator=g, dtype=torch.float64)

    def step():
        kern = gpt.make_kernel("rbf", lengthscale=0.8, input_dim=2, dtype=torch.float32)
        m = gpt.GPRegression(x.numpy(), y.numpy(), kern, noise_var=0.3, solver="iterative", precond_rank=64,
                             num_probes=8, cg_tol=1e-5, cg_iters=200, matvec_chunk=2048, seed=5,
                             dtype=torch.float32, device=cuda)
        r = m.optimize_segmented(max_iters=1, learning_rate=0.05, cg_segment_iters=8, probe_grad_chunk=4)
        return float(r.losses[0]), [p.grad.double().norm() for _, p in m._leaves()]

    before, grads = gram.gram_apply.launches, gram.gram_grad.launches
    loss_f, g_f = step()
    assert gram.gram_apply.launches > before and gram.gram_grad.launches == grads + 3
    with monkeypatch.context() as m:
        m.setattr(tgr, "fused_route", lambda *a: False)
        loss_s, g_s = step()
    med = float(torch.stack(g_s).median())
    assert abs(loss_f - loss_s) <= 5e-5 * abs(loss_s)
    assert all(abs(float(a - b)) <= 3e-3 * max(float(b), med) for a, b in zip(g_f, g_s))
