"""Kernel K10's plain version (``ops.cuda.gram.gram_grad_ref``) and the
differentiated route of ``make_gram_matvec`` (``ops.cuda.gram.GramApply``:
K9's forward, K10 in the backward) on the CPU.

The plain version is held to float64 autograd through the checkpointed slab
path, on the same (rounded) inputs and hyperparameter values, to rounding
(2 eps normwise: ``|c − c64|`` over the same sums of ``|G|``, ``|vv|``,
every term of which is then non-negative).  The route runs on the CPU with
the predicate told the tensors lie on the card (``_as_if_on_the_card``):
``GramApply`` on CPU tensors runs the plain versions, so its gradients are
held to the slab path's in float64, and every input the predicate refuses
keeps the slab path bit for bit.
"""

import pytest
import torch

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.models import gp_regression as tgr
from gp_grief_tpu_torch.ops.cuda import gram
from gp_grief_tpu_torch.utils import profiling

torch.set_num_threads(1)

KINDS = ("rbf", "exponential", "matern12", "matern32", "matern52")
F32, F64 = torch.float32, torch.float64
N = 300


def _kern(kind, d, dtype, ard=True):
    ls = torch.linspace(0.6, 1.1, d, dtype=F64) if ard else 0.8
    return gpt.make_kernel(kind, lengthscale=ls, variance=1.3, dtype=dtype)


def _data(d, B, dtype, seed=0):
    g = torch.Generator().manual_seed(seed + 100 * d + B)
    x = 3.0 * torch.rand((N, d), generator=g, dtype=F64)
    x[N // 2] = x[N // 3]  # two identical points: r² = 0 exactly
    G, V = torch.randn((2, B, N), generator=g, dtype=F64)
    return x.to(dtype), G.to(dtype), V.to(dtype)


def _as_if_on_the_card(monkeypatch):
    """The route's predicate as it reads CUDA tensors of the same dtype and
    shape: everything it checks but the device."""
    monkeypatch.setattr(tgr, "fused_route", lambda k, device_type, dtype, d: gram.fused_route(k, "cuda", dtype, d))


def _leaf_grads(k, x, G, V, sig=0.0):
    """Autograd through ``make_gram_matvec`` of ``Σ G ⊙ mv(V)``: the
    gradients of the kernel's two leaves."""
    L = torch.sum(G * tgr.make_gram_matvec(k, x, sig, chunk=128)(V))
    return [g.double() for g in torch.autograd.grad(L, [k.log_lengthscale, k.log_variance])]


@pytest.mark.parametrize("ard", [True, False], ids=["ard", "iso"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 4, 9, 17])
@pytest.mark.parametrize("d", [1, 2, 5, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_gradient_is_the_slab_paths(kind, d, B, dtype, ard):
    x, G, V = _data(d, B, dtype)
    k = _kern(kind, d, dtype, ard)
    k64 = _kern(kind, d, F64, ard)
    with torch.no_grad():  # the same hyperparameter values, exactly
        k64.log_lengthscale.copy_(k.log_lengthscale.double())
        k64.log_variance.copy_(k.log_variance.double())
    want_ls, want_var = _leaf_grads(k64, x.double(), G.double(), V.double())
    ls, var = torch.broadcast_to(k.lengthscale.detach(), (d,)), k.variance.detach()
    c_var, c_ls = gram.gram_grad_ref(kind, x, G, V, ls, var)
    assert c_var.dtype == dtype and c_ls.dtype == dtype and c_ls.shape == (d,)
    a_var, a_ls = gram.gram_grad_ref(kind, x.double(), G.double().abs(), V.double().abs(), ls.double(),
                                     var.double())
    # ∂/∂log = value · ∂/∂value; an isotropic lengthscale's is the sum over d.
    got_ls, scale_ls = c_ls.double() * ls.double(), a_ls * ls.double()
    if not ard:
        got_ls, scale_ls = got_ls.sum(), scale_ls.sum()
    err = max(float((c_var.double() * var.double() - want_var).abs() / (a_var * var.double())),
              float(((got_ls - want_ls).abs() / scale_ls).max()))
    assert err <= 2 * torch.finfo(dtype).eps, err


def test_gram_grad_checks_its_operands():
    x, G, V = _data(2, 4, F64)
    ls, var = torch.tensor([0.7, 0.9], dtype=F64), torch.tensor(1.3, dtype=F64)
    with pytest.raises(ValueError):
        gram.gram_grad("rbf", x, G[:, :-1], V, ls, var)
    with pytest.raises(ValueError):
        gram.gram_grad("rbf", x, G[:2], V, ls, var)
    with pytest.raises(ValueError):
        gram.gram_grad("rbf", x, G, V, ls[:1], var)
    with pytest.raises(TypeError):
        gram.gram_grad("rbf", x, G.float(), V, ls, var)


def _run(k, x, V, sig, W, precision="highest"):
    """Under a profiler, ``L = Σ W ⊙ mv(V)`` and its backward: L, the
    counters and ``gp_grief.*`` span calls, and every gradient (the
    kernels' leaves, then σ²'s, V's and x's where they require grad)."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = tgr.make_gram_matvec(k, x, sig, chunk=128, precision=precision)(V)
        L = torch.sum(W * out)
        L.backward()
    snap = profiling.snapshot()
    calls = {name: s["calls"] for name, s in snap["spans"].items()}
    grads = [p.grad for p in tgr._kernel_params(k)] + [t.grad for t in (sig, V, x) if t.requires_grad]
    return L.detach(), snap["counters"], calls, grads


def _operands(kind, d, B, dtype, ard=True, grad_v=False, grad_x=False):
    x, W, V = _data(d, B, dtype, seed=1)
    k = _kern(kind, d, dtype, ard)
    sig = torch.tensor(0.3, dtype=dtype, requires_grad=True)
    return k, x.requires_grad_(grad_x), V.requires_grad_(grad_v), sig, W


@pytest.mark.parametrize("ard", [True, False], ids=["ard", "iso"])
@pytest.mark.parametrize("grad_v", [False, True], ids=["v-const", "v-grad"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_grad_route_is_the_slab_path(monkeypatch, kind, grad_v, ard):
    """The differentiated apply on ``GramApply`` against the slab path in
    float64: the value, the kernel's leaves', σ²'s and (``v-grad``) V's
    gradients; one K10 call (``gram_fused_grads``) in the backward, in the
    span ``gp_grief.gram.grad``, and no slab built."""
    d, B = 3, 4
    L_s, c_s, calls_s, g_s = _run(*_operands(kind, d, B, F64, ard, grad_v))
    _as_if_on_the_card(monkeypatch)
    L_f, c_f, calls_f, g_f = _run(*_operands(kind, d, B, F64, ard, grad_v))
    assert c_s.get("gram_fused_grads", 0) == 0 and calls_s["gp_grief.gram.slab"] > 0
    assert c_f["gram_fused_grads"] == 1 and calls_f["gp_grief.gram.grad"] == 1
    assert "gp_grief.gram.slab" not in calls_f and c_f.get("gram_fused_applies", 0) == 0
    assert len(g_f) == len(g_s) == 3 + grad_v
    assert float((L_f - L_s).abs()) <= 1e-12 * float(L_s.abs())
    for got, want in zip(g_f, g_s):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max()), (got, want)


@pytest.mark.parametrize("refused", ["x-grad", "default", "bf16-state", "product"])
def test_refused_inputs_keep_the_slab_path(monkeypatch, refused):
    """Each input the predicate refuses takes the checkpointed slab path, bit
    for bit the path it takes with no route at all."""

    def operands():
        k, x, V, sig, W = _operands("matern32", 2, 4, F32, grad_x=refused == "x-grad")
        if refused == "bf16-state":
            V = V.to(torch.bfloat16)
        if refused == "product":
            k = [_kern("matern32", 1, F32), _kern("rbf", 1, F32)]
        return k, x, V, sig, W

    def run():
        return _run(*operands(), precision="default" if refused == "default" else "highest")

    _, _, calls_s, g_s = run()
    _as_if_on_the_card(monkeypatch)
    _, counters, calls, g_f = run()
    assert counters.get("gram_fused_grads", 0) == 0 and "gp_grief.gram.grad" not in calls
    assert calls["gp_grief.gram.slab"] == calls_s["gp_grief.gram.slab"] > 0
    assert len(g_f) == len(g_s) >= 3 and all(torch.equal(a, b) for a, b in zip(g_f, g_s))


def test_no_k10_call_where_no_hyperparameter_needs_one(monkeypatch):
    """Only V (and σ²) requiring grad: the route's backward gives V its
    cotangent and makes no K10 call."""
    _as_if_on_the_card(monkeypatch)
    k, x, V, sig, W = _operands("rbf", 2, 4, F64, grad_v=True)
    k.requires_grad_(False)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        torch.sum(W * tgr.make_gram_matvec(k, x, sig, chunk=128)(V)).backward()
    snap = profiling.snapshot()
    assert snap["counters"].get("gram_fused_grads", 0) == 0 and snap["spans"]["gp_grief.gram.grad"]["calls"] == 1
    want = gram.gram_apply_ref(k, x, W, sig.detach())
    assert float((V.grad - want).abs().max()) <= 1e-12 * float(want.abs().max())
