"""Kernels K2 and K3 on the card: the CUDA passes against their plain version.

Marked ``cuda``; without a CUDA device every test skips.  On a GPU machine
without jax run ``python -m pytest --noconftest tests/test_torch_kron_cuda.py``
(``tests/conftest.py`` imports jax; this file does not).  Shapes: small
ragged and rectangular lattices that exercise every pass kind (tile passes of
one to three axes, with and without trailing columns, and wide passes), and
the two grid configurations' lattices.
"""

import math

import pytest
import torch

from gp_grief_tpu_torch.ops.cuda import kron as tk
from gp_grief_tpu_torch.ops.kron_fast import kron_matvec_fast

pytestmark = pytest.mark.cuda

# Relative norm error against the plain version, which contracts in the same
# order and rounds at the same points: exact grade differs by float32
# summation order only; the fast grade also by the rare bf16 rounding that
# such a difference tips over.
TOL = {"highest": 1e-5, "default": 2e-3}
# Against the exact product: the fast grade's own error class (the JAX
# package's slab test holds DEFAULT to 2e-2).
FAST_VS_EXACT = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(sizes, outs, B, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    fs = [torch.randn((o, m), generator=g, dtype=torch.float64) / m**0.5 for o, m in zip(outs, sizes)]
    v = torch.randn((math.prod(sizes), B), generator=g, dtype=torch.float64)
    return [f.to(device, torch.float32) for f in fs], v.to(device, torch.float32)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


CASES = [  # (wrapper, sizes, outs, B)
    ("slab", (4, 4, 8, 8, 8), None, 1),
    ("slab", (4, 16, 8, 16, 8), None, 3),
    ("slab", (3, 5, 7, 9), None, 2),
    ("fused", (12, 24, 96), None, 1),
    ("fused", (8, 12, 24, 96), None, 1),
    ("fused", (96, 128), None, 1),
    ("fused", (20, 28, 96), (17, 30, 100), 1),
    ("fused", (8, 64, 100), None, 128),
]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("which,sizes,outs,B", CASES)
def test_kernel_matches_plain_version(cuda, which, sizes, outs, B, precision):
    outs = outs or sizes
    fs, v = _operands(sizes, outs, B, cuda)
    fn = tk.kron_matvec_slab if which == "slab" else tk.kron_matvec_fused
    before = fn.launches
    got = fn(fs, v, precision=precision)
    torch.cuda.synchronize()
    assert fn.launches - before == len(tk._hopper_plan(list(sizes), list(outs), B))
    fast = precision == "default"
    plain = tk.kron_chain_ref(fs, v, fast=fast)
    exact = tk.kron_chain_ref([f.double() for f in fs], v.double())
    assert got.shape == (math.prod(outs), B) and got.dtype == torch.float32
    assert _rel(got, plain) < TOL[precision]
    assert _rel(got, exact) < (FAST_VS_EXACT if fast else 1e-5)


def test_slab_bf16_storage_between_passes(cuda):
    fs, v = _operands((4, 16, 8, 16, 8), (4, 16, 8, 16, 8), 1, cuda)
    got = tk.kron_matvec_slab(fs, v, precision="default", mid_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert _rel(got, tk.kron_chain_ref(fs, v, fast=True)) < TOL["default"]


@pytest.mark.parametrize("which", ["slab", "fused"])
def test_bf16_input_vector(cuda, which):
    """The mixed16 CG state reaches the kernel as bf16: fast grade, bf16 out."""
    sizes = (4, 16, 8, 16, 8) if which == "slab" else (12, 24, 96)
    fs, v = _operands(sizes, sizes, 1, cuda)
    vb = v.to(torch.bfloat16)
    fn = tk.kron_matvec_slab if which == "slab" else tk.kron_matvec_fused
    got = fn(fs, vb[:, 0], precision="highest")
    assert got.dtype == torch.bfloat16 and got.shape == (math.prod(sizes),)
    plain = tk.kron_chain_ref(fs, vb, fast=True)[:, 0]
    assert _rel(got, plain) < 1e-2  # both round the result to bf16 once more


def test_grid_lattices_route_to_their_kernels(cuda):
    """The two grid configurations' matvecs: 32^5 at "default" goes to K2,
    8x512x512 at "highest" to K3; both agree with the plain version."""
    fs, v = _operands((32,) * 5, (32,) * 5, 1, cuda, seed=1)
    before = tk.kron_matvec_slab.launches
    got = kron_matvec_fast(fs, v[:, 0], precision="default")
    assert tk.kron_matvec_slab.launches == before + 2
    assert _rel(got, tk.kron_chain_ref(fs, v, fast=True)[:, 0]) < TOL["default"]
    fs, v = _operands((8, 512, 512), (8, 512, 512), 1, cuda, seed=2)
    before = tk.kron_matvec_fused.launches
    got = kron_matvec_fast(fs, v[:, 0], precision="highest")
    assert tk.kron_matvec_fused.launches == before + 3
    assert _rel(got, tk.kron_chain_ref(fs, v)[:, 0]) < TOL["highest"]


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    fs, v = _operands((4, 4, 8), (4, 4, 8), 1, cuda)
    before = tk.kron_matvec_slab.launches
    with pytest.raises(ValueError, match="contiguous"):
        tk.kron_matvec_slab([fs[0].T, *fs[1:]], v)
    with pytest.raises(TypeError, match="float32 factors"):
        tk.kron_matvec_slab([f.double() for f in fs], v.double())
    assert tk.kron_matvec_slab.launches == before
