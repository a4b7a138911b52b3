"""Kernel K1 on the card: the CUDA kernel against its plain version.

Marked ``cuda``; without a CUDA device every test skips.  On a GPU machine
without jax run ``python -m pytest --noconftest tests/test_torch_phi_cuda.py``
(``tests/conftest.py`` imports jax; this file does not).  The shapes are the
ones the main path hands K1 (kin40k statistics and predict, one uci2m
statistics chunk, d100's Φ) and ragged ones that fit no tile.
"""

import numpy as np
import pytest
import torch

from gp_grief_tpu_torch.ops.cuda import phi_fused, phi_fused_ref

pytestmark = pytest.mark.cuda

# Per element, relative to Π_d Σ_k |B_dk S_kj| (the scale of the rounding
# error of a product of d m-deep dots): float32 rounds ~d+m terms at 6e-8.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

SHAPES = [  # (d, n, m, p)
    (8, 30000, 16, 400),
    (8, 10000, 16, 400),
    (10, 131072, 10, 400),
    (100, 1000, 10, 300),  # d100: 100 stages, p not a multiple of the 80-wide tile
    (5, 4099, 37, 211),
    (2, 1, 1, 1),
    (3, 65, 17, 65),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(d, n, m, p, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = torch.rand((d, n, m), generator=g, dtype=torch.float64)
    S = torch.randn((d, m, p), generator=g, dtype=torch.float64) / m**0.5
    return B.to(device=device, dtype=dtype), S.to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(cuda, shape, dtype):
    B, S = _operands(*shape, dtype, cuda)
    before = phi_fused.launches
    got = phi_fused(B, S)
    torch.cuda.synchronize()
    assert phi_fused.launches == before + 1
    ref = phi_fused_ref(B, S)
    scale = phi_fused_ref(B.abs(), S.abs()).clamp_min(torch.finfo(dtype).tiny)
    assert got.shape == ref.shape
    assert float(((got - ref).abs() / scale).max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [211, 400])
@pytest.mark.parametrize("m", [10, 16, 37])
@pytest.mark.parametrize("d", [2, 8, 10])
def test_kernel_depths_widths_and_ragged_rows(cuda, d, m, p, dtype):
    """Depths under, at and over one 16-deep stage, a width the 80-column
    tile divides and one it does not, and a row count no tile divides; two
    launches give the same bits."""
    B, S = _operands(d, 1031, m, p, dtype, cuda, seed=d + m + p)
    got = phi_fused(B, S)
    again = phi_fused(B, S)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = phi_fused_ref(B, S)
    scale = phi_fused_ref(B.abs(), S.abs()).clamp_min(torch.finfo(dtype).tiny)
    assert float(((got - ref).abs() / scale).max()) <= TOL[dtype]


def test_build_or_launch_failure_raises(cuda, monkeypatch):
    from gp_grief_tpu_torch.ops.cuda import _build

    B, S = _operands(3, 64, 8, 16, torch.float32, cuda)

    def no_build():
        raise RuntimeError("nvcc failed with exit code 1")

    monkeypatch.setattr(_build, "load_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        phi_fused(B, S)

    class Refusing:  # every entry point reports cudaErrorInvalidConfiguration
        def __getattr__(self, name):
            return lambda *args: 9

    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    before = phi_fused.launches
    with pytest.raises(RuntimeError, match="cudaError 9"):
        phi_fused(B, S)
    assert phi_fused.launches == before


def test_unsupported_dtype_raises(cuda):
    B, S = _operands(3, 64, 8, 16, torch.float16, cuda)
    before = phi_fused.launches
    with pytest.raises(TypeError, match="float32 or float64"):
        phi_fused(B, S)
    assert phi_fused.launches == before


def test_non_contiguous_raises(cuda):
    B, S = _operands(3, 64, 8, 16, torch.float32, cuda)
    before = phi_fused.launches
    with pytest.raises(ValueError, match="contiguous"):
        phi_fused(B.transpose(1, 2).contiguous().transpose(1, 2), S)
    with pytest.raises(ValueError, match="contiguous"):
        phi_fused(B, S[:, :, ::2])
    assert phi_fused.launches == before


def test_kernel_param_gradient_is_reproducible(cuda):
    """The differentiated basis path (eigh, top-p, batched Φ with repeated
    eigenvector columns) gives bitwise identical gradients on every
    evaluation: nothing in its backward sums with atomics."""
    import gp_grief_tpu_torch as gpt

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(20000, 6)).astype(np.float32)
    y = (np.sin(3 * x[:, 0] * x[:, 1]) + x[:, 2]).astype(np.float32)
    kerns = [gpt.make_kernel("rbf", lengthscale=0.7) for _ in range(6)]
    model = gpt.GPGriefModel(x, y, kerns, gpt.InducingGrid.build(x, mbar=12), n_eigs=300,
                             noise_var=0.1, device=cuda, opt_kernel_params=True, dim_noise_var=1e-6)
    params = [p for _, p in model.named_parameters()]
    grads = [torch.cat([g.reshape(-1) for g in torch.autograd.grad(model._loss(), params)])
             for _ in range(3)]
    assert bool(torch.isfinite(grads[0]).all())
    assert all(torch.equal(grads[0], g) for g in grads[1:])


def test_backward_on_card_matches_plain(cuda):
    B, S = _operands(4, 300, 9, 50, torch.float64, cuda)
    B1, S1 = B.clone().requires_grad_(), S.clone().requires_grad_()
    B2, S2 = B.clone().requires_grad_(), S.clone().requires_grad_()
    G = torch.randn(300, 50, dtype=torch.float64, device=cuda)
    (phi_fused(B1, S1) * G).sum().backward()
    (phi_fused_ref(B2, S2) * G).sum().backward()
    np.testing.assert_allclose(B1.grad.cpu().numpy(), B2.grad.cpu().numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(S1.grad.cpu().numpy(), S2.grad.cpu().numpy(), rtol=1e-12, atol=1e-14)
