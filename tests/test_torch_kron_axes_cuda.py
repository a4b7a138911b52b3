"""Kernels K6, K7 and K8 on the card: the CUDA passes against their plain versions.

Marked ``cuda``; without a CUDA device every test skips.  On a GPU machine
without jax run ``python -m pytest --noconftest tests/test_torch_kron_axes_cuda.py``
(``tests/conftest.py`` imports jax; this file does not).  Shapes: chip_smoke.py
phase 10's cases shrunk eightfold, a rectangular tail with o > n, a tail with
an axis wider than 64 (a chain of a tile and a wide pass) and an odd N for K6;
the edges of the tile member's row batches and of the wide member's tiles,
chunks and copy widths; bf16 in and out of the wide member.
"""

import math

import pytest
import torch

from gp_grief_tpu_torch.ops.cuda import kron as tk
from gp_grief_tpu_torch.ops.cuda import kron_axes as ka

pytestmark = pytest.mark.cuda

# Relative norm error against the plain version, which contracts in the same
# order and rounds at the same points: summation order at the exact grade;
# at "default" also the rare bf16 rounding such a difference tips over.
TOL = {"highest": 1e-5, "default": 2e-3}
# Against a float64 run of the plain version: the fast grade's own class.
VS_EXACT = {"highest": 1e-5, "default": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, g):
    return torch.randn(shape, generator=g, dtype=torch.float64)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _factors(shapes, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [(_randn(s, g) / s[1] ** 0.5).to(device, torch.float32) for s in shapes]


K7_CASES = [  # (factor shapes (o, m), B)
    ([(32, 32)] * 4 + [(4, 4)], 1),
    ([(32, 32)] * 4 + [(4, 4)], 8),
    ([(48, 40), (12, 16), (20, 16)], 8),  # rectangular, o != m
    ([(96, 80), (24, 32), (40, 32)], 1),  # an axis wider than 64: a wide pass
    # The wide member's C_p = K·X_p role with post ragged against its tile:
    ([(96, 80), (50, 50)], 1),  # post 50 in a 64-wide tile
    ([(96, 80), (20, 10)], 10),  # post 200 in 128-wide tiles
    ([(70, 200), (8, 8)], 3),  # depth 200: not a multiple of the 16-deep chunk
    ([(16, 1024), (8, 8)], 64),  # depth 1024 in the C_p = K·X_p role
]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("shapes,B", K7_CASES)
def test_kron_matmat_matches_plain_version(cuda, shapes, B, precision):
    fs = _factors(shapes, cuda)
    M = math.prod(s[1] for s in shapes)
    v = _randn((M, B), torch.Generator().manual_seed(1)).to(cuda, torch.float32)
    before = ka.kron_matmat_cuda.launches
    got = ka.kron_matmat_cuda(fs, v, precision=precision)
    again = ka.kron_matmat_cuda(fs, v, precision=precision)
    torch.cuda.synchronize()
    plan = tk._hopper_plan([s[1] for s in shapes], [s[0] for s in shapes], B)
    assert ka.kron_matmat_cuda.launches - before == 2 * len(plan)
    assert torch.equal(got, again)
    fast = precision == "default"
    assert got.shape == (math.prod(s[0] for s in shapes), B)
    assert _rel(got, tk.kron_chain_ref(fs, v, fast=fast)) < TOL[precision]
    assert _rel(got, tk.kron_chain_ref([f.double() for f in fs], v.double())) < VS_EXACT[precision]


def test_kron_matmat_gradient_matches_plain_chain(cuda):
    fs = [f.requires_grad_() for f in _factors([(12, 16), (20, 24), (8, 8)], cuda)]
    g = torch.Generator().manual_seed(2)
    v = _randn((16 * 24 * 8, 3), g).to(cuda, torch.float32).requires_grad_()
    G = _randn((12 * 20 * 8, 3), g).to(cuda, torch.float32)
    grads = torch.autograd.grad(torch.sum(ka.kron_matmat_cuda(fs, v) * G), [v, *fs])
    want = torch.autograd.grad(torch.sum(tk.kron_chain_ref(fs, v) * G), [v, *fs])
    for a, b in zip(grads, want):
        assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("N,S,So", [
    (32768, 128, 128), (4097, 48, 64), (1000, 200, 72),
    (4097, 50, 64), (4097, 50, 72),  # rows of 50 floats: 4-byte copies, a ragged last chunk
    (3, 80, 64), (129, 128, 65),  # fewer rows than a tile; a ragged output tile
    (4097, 1024, 64),  # a 1024-deep contraction: 3xTF32's error grows with depth
])
def test_last_slab_pass_matches_plain_version(cuda, N, S, So):
    g = torch.Generator().manual_seed(3)
    x2 = _randn((N, S), g).to(cuda, torch.float32)
    W = (_randn((So, S), g) / S**0.5).to(cuda, torch.float32)
    before = ka.last_slab_pass.launches
    got = ka.last_slab_pass(x2, W)
    again = ka.last_slab_pass(x2, W)
    torch.cuda.synchronize()
    assert ka.last_slab_pass.launches - before == 2
    assert torch.equal(got, again) and got.shape == (N, So)
    assert _rel(got, ka.last_slab_pass_ref(x2, W)) < TOL["highest"]
    assert _rel(got, ka.last_slab_pass_ref(x2.double(), W.double())) < VS_EXACT["highest"]


TAIL_CASES = [  # (leading N, factor shapes (o, m))
    (128, [(32, 32)] * 3),
    (4096, [(32, 32)] * 2),
    (64, [(30, 24), (20, 16), (40, 32)]),  # rectangular, o > n, one tile pass
    (64, [(40, 24), (36, 32), (48, 20)]),  # o > n, too large for one tile: a chain
    (500, [(96, 80), (32, 32)]),  # an axis wider than 64: wide and tile passes
]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("N,shapes", TAIL_CASES)
def test_tail_passes_match_plain_version(cuda, N, shapes, precision):
    Ks = _factors(shapes, cuda, seed=4)
    x = _randn((N, *(s[1] for s in shapes)), torch.Generator().manual_seed(5)).to(cuda, torch.float32)
    fn, ref = (ka.tail3_pass, ka.tail3_pass_ref) if len(shapes) == 3 else (ka.tail2_pass, ka.tail2_pass_ref)
    before = fn.launches
    got = fn(x, *Ks, precision=precision)
    again = fn(x, *Ks, precision=precision)
    torch.cuda.synchronize()
    plan = tk._hopper_plan([s[1] for s in shapes], [s[0] for s in shapes], 1)
    assert fn.launches - before == 2 * len(plan)
    assert torch.equal(got, again) and got.shape == (N, *(s[0] for s in shapes))
    assert _rel(got, ref(x, *Ks, precision=precision)) < TOL[precision]
    exact = ref(x.double(), *[K.double() for K in Ks])
    assert _rel(got, exact) < VS_EXACT[precision]


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("rows", ["3", "4097", "two_waves"])
def test_tail_passes_at_row_batch_edges(cuda, g, rows):
    """The tile member's row batches: fewer rows than a batch, a ragged last
    batch, and an exact multiple of one resident wave (blocks per SM × SMs ×
    rows per block; tail2_pass batches 16 rows, tail3_pass's 144 KB tile 1)."""
    Ks = _factors([(32, 32)] * g, cuda, seed=7)
    R = tk._tile_rows([32] * g, [32] * g, 1, 1, 1 << 20)
    per_sm = 2 if R > 1 else 1
    N = {"3": 3, "4097": 4097}.get(rows) or 2 * R * per_sm * torch.cuda.get_device_properties(cuda).multi_processor_count
    x = _randn((N,) + (32,) * g, torch.Generator().manual_seed(8)).to(cuda, torch.float32)
    fn, ref = (ka.tail3_pass, ka.tail3_pass_ref) if g == 3 else (ka.tail2_pass, ka.tail2_pass_ref)
    for precision in ("highest", "default"):
        got = fn(x, *Ks, precision=precision)
        again = fn(x, *Ks, precision=precision)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and got.shape == x.shape
        assert _rel(got, ref(x, *Ks, precision=precision)) < TOL[precision]
        assert _rel(got, ref(x.double(), *[K.double() for K in Ks])) < VS_EXACT[precision]


# Wide passes with a bf16 vector in and a bf16 result out, at "default":
# (entry, factor shapes (o, m) or W's, input shape).  Rows of 48 bf16 take
# 16-byte copies, of 50 4-byte copies, of 49 element-wise loads.
WIDE_BF16_CASES = [
    ("last_slab_pass", [(64, 48)], (4097, 48)),
    ("last_slab_pass", [(72, 50)], (1000, 50)),
    ("last_slab_pass", [(64, 49)], (1000, 49)),
    ("kron_matmat_cuda", [(32, 32), (96, 80)], (32 * 80, 4)),  # C_p role first: x_p bf16 in
    ("kron_matmat_cuda", [(96, 80), (32, 32)], (80 * 32, 1)),  # C_p role last: bf16 out
]


@pytest.mark.parametrize("entry,shapes,xshape", WIDE_BF16_CASES)
def test_wide_pass_bf16_in_and_out(cuda, entry, shapes, xshape):
    fs = _factors(shapes, cuda, seed=9)
    x = _randn(xshape, torch.Generator().manual_seed(10)).to(cuda, torch.bfloat16)
    if entry == "last_slab_pass":
        run = lambda: ka.last_slab_pass(x, fs[0])  # noqa: E731
        want = ka.last_slab_pass_ref(x.float(), fs[0], fast=True)
    else:
        run = lambda: ka.kron_matmat_cuda(fs, x, precision="default")  # noqa: E731
        want = tk.kron_chain_ref(fs, x.float(), fast=True)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert _rel(got, want) < 1e-2  # the kernel rounds its result to bf16 once more


def test_bf16_input_gives_bf16(cuda):
    Ks = _factors([(32, 32)] * 2, cuda)
    x = _randn((256, 32, 32), torch.Generator().manual_seed(6)).to(cuda, torch.bfloat16)
    got = ka.tail2_pass(x, *Ks)
    assert got.dtype == torch.bfloat16
    assert _rel(got, ka.tail2_pass_ref(x.float(), *Ks, precision="default")) < 1e-2


def test_entry_points_raise_on_what_the_kernels_do_not_take(cuda):
    Ks = _factors([(8, 8)] * 3, cuda)
    x = torch.ones((4, 8, 8, 8), device=cuda)
    counts = [f.launches for f in (ka.tail3_pass, ka.last_slab_pass, ka.kron_matmat_cuda)]
    with pytest.raises(TypeError, match="float32"):
        ka.tail3_pass(x.double(), *Ks)
    with pytest.raises(TypeError, match="float32"):
        ka.tail3_pass(x.double(), *[K.double() for K in Ks])
    with pytest.raises(TypeError, match="float32"):
        ka.last_slab_pass(x.reshape(256, 8).double(), Ks[0].double())
    with pytest.raises(TypeError, match="float32"):
        ka.kron_matmat_cuda([K.double() for K in Ks], x[0].reshape(-1).double())
    with pytest.raises(ValueError, match="contiguous"):
        ka.tail3_pass(x, Ks[0].T, *Ks[1:])
    assert counts == [f.launches for f in (ka.tail3_pass, ka.last_slab_pass, ka.kron_matmat_cuda)]
