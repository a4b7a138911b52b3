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
    # Wide passes whose depth is not a multiple of the 16-deep chunk (80,
    # 200) and whose C_p role has post ragged against a 128-wide tile (100).
    ("fused", (12, 200), (10, 120), 1),
    ("fused", (6, 80, 100), None, 1),
]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("which,sizes,outs,B", CASES)
def test_kernel_matches_plain_version(cuda, which, sizes, outs, B, precision):
    outs = outs or sizes
    fs, v = _operands(sizes, outs, B, cuda)
    fn = tk.kron_matvec_slab if which == "slab" else tk.kron_matvec_fused
    before = fn.launches
    got = fn(fs, v, precision=precision)
    again = fn(fs, v, precision=precision)
    torch.cuda.synchronize()
    assert fn.launches - before == 2 * len(tk._hopper_plan(list(sizes), list(outs), B))
    assert torch.equal(got, again)
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


# K2 at the fast grade, on the tensor-core tile member: (sizes, B, vector
# dtype, mid_dtype).  32^5 (the grid configuration), a 64-point axis, ragged
# d = 5 extents padded to the mma shape, a bf16 input vector, bf16 storage
# between passes, and batches.
FAST_SLAB_CASES = [
    ((32,) * 5, 1, torch.float32, torch.bfloat16),
    ((32,) * 5, 1, torch.float32, None),
    ((64, 16, 32, 64), 1, torch.float32, torch.bfloat16),
    ((4, 16, 8, 16, 8), 1, torch.float32, torch.bfloat16),
    ((5, 12, 9, 20, 7), 1, torch.float32, None),
    ((4, 16, 8, 16, 8), 1, torch.bfloat16, None),
    ((16, 32, 32, 32), 3, torch.float32, torch.bfloat16),
    ((8, 32, 32, 32), 16, torch.float32, None),
]


@pytest.mark.parametrize("sizes,B,vdtype,mid", FAST_SLAB_CASES)
def test_slab_fast_grade_on_the_tensor_cores(cuda, sizes, B, vdtype, mid):
    fs, v = _operands(sizes, sizes, B, cuda, seed=5)
    v = v.to(vdtype)
    passes = tk._passes(tuple(sizes), tuple(sizes), B, 1, None, True)
    assert any(not wide and args[-1] == 1 for *_, wide, args in passes)  # a pass on the mma member
    before = tk.kron_matvec_slab.launches
    got = tk.kron_matvec_slab(fs, v, precision="default", mid_dtype=mid)
    again = tk.kron_matvec_slab(fs, v, precision="default", mid_dtype=mid)
    torch.cuda.synchronize()
    assert tk.kron_matvec_slab.launches - before == 2 * len(passes)
    assert torch.equal(got, again) and got.dtype == vdtype and got.shape == (math.prod(sizes), B)
    plain = tk.kron_chain_ref(fs, v.float(), fast=True)
    exact = tk.kron_chain_ref([f.double() for f in fs], v.double())
    # A bf16 result is rounded once more than the plain version's.
    assert _rel(got, plain) < (1e-2 if vdtype == torch.bfloat16 else TOL["default"])
    assert _rel(got, exact) < FAST_VS_EXACT


# A bf16 vector takes the fast grade, whose every pass rounds its operand to
# bf16: bf16 storage between K2's passes (what kron_matvec_fast asks for
# there) gives the bits of float32 storage.  (lead, sizes): the lattice dual's
# mixed16 solves at 8 and 16 probes, the grid's mixed16 state, a case whose
# passes run the FP32 tile member.
BF16_MID_CASES = [(9, (32,) * 4), (17, (32,) * 4), (0, (32,) * 5), (0, (5, 12, 9, 20, 7)), (3, (4, 16, 8, 16, 8))]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("lead,sizes", BF16_MID_CASES)
def test_slab_bf16_vector_mid_storage_keeps_the_bits(cuda, lead, sizes, precision):
    fs, v = _operands(sizes, sizes, 1, cuda, seed=7)
    if lead:
        fs = [tk.batch_identity(lead, device=cuda), *fs]
        v = torch.randn((lead * v.shape[0], 1), generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    vb = v.to(torch.bfloat16)
    before = tk.kron_matvec_slab.launches
    f32_mid = tk.kron_matvec_slab(fs, vb, precision=precision)
    bf16_mid = tk.kron_matvec_slab(fs, vb, precision=precision, mid_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    core = tuple(sizes)
    assert tk.kron_matvec_slab.launches - before == 2 * len(tk._passes(core, core, 1, max(lead, 1), None, True))
    assert bf16_mid.dtype == torch.bfloat16 and torch.equal(f32_mid, bf16_mid)
    routed = kron_matvec_fast(fs, vb, precision="BF16_BF16_F32_X3")  # the lattice dual's mixed16 call
    assert torch.equal(routed, bf16_mid)


# sha256 of the exact grade's (X3: the SKI lattice's Q/Qᵀ at B = 8) float32
# output bytes from the FP32 tile member as it stood before the tensor-core
# member was added, on an H100: the exact grade keeps those bits.
X3_DIGEST = "264a185a3895fafbb9e264b2dee9f05f525616b2233747ca012eb683bc1ce922"


def test_slab_exact_grade_keeps_its_bits(cuda):
    import hashlib

    g = torch.Generator().manual_seed(4)
    Qs = [torch.linalg.qr(torch.randn((32, 32), generator=g, dtype=torch.float64))[0].float() for _ in range(4)]
    fs = [torch.eye(8).to(cuda), *[Q.contiguous().to(cuda) for Q in Qs]]
    v = torch.randn((8 * 32**4,), generator=g, dtype=torch.float64).float().to(cuda)
    got = kron_matvec_fast(fs, v, precision="BF16_BF16_F32_X3")
    torch.cuda.synchronize()
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == X3_DIGEST


# The exact grade's tile member (csrc kron_exact_tile_kernel), one pass at a
# time through the plan argument of the wrappers' launcher: (case, factor
# shapes (o, n), lead rows of pre, B columns of post).  At post = 1 the
# innermost axis is contracted as its rows land (a lone innermost axis writes
# its rows straight out); with columns, n x P blocks land.  The plan picks P
# and R (_exact_tile_plan).
EXACT_TILE_CASES = [
    ("g1_rows_ragged_tile", [(24, 20)], 4099, 1),  # 3 of 4 output slices; R = 8, the last tile 3 rows
    ("g1_rows_4byte_copies", [(7, 5)], 1000, 1),  # rows of 5 floats: 4-byte copies
    ("g1_cols_R_batches", [(8, 8)], 600, 24),  # P = post = 24, R = 2
    ("g1_cols_column_tiles", [(40, 32)], 2, 3000),  # P = 128: 24 column tiles, the last 56 wide
    ("g1_many_outputs", [(100, 20)], 5, 1),  # 16 slices of 8 outputs
    ("g2_rows_rectangular", [(17, 24), (30, 20)], 300, 1),
    ("g2_rows_R_batches", [(8, 8), (8, 8)], 600, 1),  # R = 2
    ("g2_cols_ragged_tile", [(17, 20), (24, 24)], 3, 40),  # P = 32: the second tile 8 wide
    ("g2_cols_R_batches", [(8, 8), (8, 8)], 2000, 4),  # P = post = 4, R = 4
    ("g2_cols_post_8", [(32, 32), (32, 32)], 500, 8),  # X3's first pass at B = 8
    ("g3_rows_multi_chunk", [(13, 12), (33, 40), (24, 20)], 3, 1),  # 480 rows a tile in chunks of 256
    ("g3_rows_32cubed", [(32, 32)] * 3, 300, 1),  # tail3_pass / K2's first pass at 32^5
    ("g3_cols_4byte_copies", [(2, 3), (6, 4), (3, 5)], 2, 7),  # P = 7: 4-byte copies
    ("g3_cols_E_over_n", [(12, 9), (3, 4), (4, 8)], 2, 13),  # o > n on axis 0: T's slots skip
]


@pytest.mark.parametrize("case,shapes,lead,B", EXACT_TILE_CASES, ids=[c[0] for c in EXACT_TILE_CASES])
def test_exact_tile_member(cuda, case, shapes, lead, B):
    """Each case twice bit for bit, within 1e-5 of the plain float32 chain
    and of float64."""
    g = torch.Generator().manual_seed(len(case))
    fs = [(torch.randn(s, generator=g, dtype=torch.float64) / s[1] ** 0.5).to(cuda, torch.float32) for s in shapes]
    ns, outs = [s[1] for s in shapes], [s[0] for s in shapes]
    v = torch.randn((lead * math.prod(ns), B), generator=g, dtype=torch.float64).to(cuda, torch.float32)
    plan = ((0, len(shapes) - 1, 1),)
    (_, _, _, wide, args), = tk._passes(tuple(ns), tuple(outs), B, lead, plan, False)
    assert not wide and args[-1] == 0
    before = tk.kron_matvec_fused.launches
    got = tk._launch(tk.kron_matvec_fused, fs, v, False, None, B, lead=lead, plan=plan).reshape(-1, B)
    again = tk._launch(tk.kron_matvec_fused, fs, v, False, None, B, lead=lead, plan=plan).reshape(-1, B)
    torch.cuda.synchronize()
    assert tk.kron_matvec_fused.launches - before == 2
    assert torch.equal(got, again)
    eye = torch.eye(lead, device=cuda)
    plain = tk.kron_chain_ref([eye, *fs], v)
    exact = tk.kron_chain_ref([eye.double(), *[f.double() for f in fs]], v.double())
    assert got.shape == plain.shape
    assert _rel(got, plain) < TOL["highest"]
    assert _rel(got, exact) < 1e-5


def test_wide_member_exact_grade_at_depth_1024(cuda):
    """3xTF32's error grows with the contraction depth: K3 at (8, 1024, 1024)
    "highest" runs two 1024-deep wide passes, held to the same 1e-5 limits
    against the plain version and against float64."""
    fs, v = _operands((8, 1024, 1024), (8, 1024, 1024), 1, cuda, seed=3)
    assert [p[2] for p in tk._hopper_plan([8, 1024, 1024], [8, 1024, 1024], 1)][:2] == [0, 0]
    got = tk.kron_matvec_fused(fs, v, precision="highest")
    again = tk.kron_matvec_fused(fs, v, precision="highest")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, tk.kron_chain_ref(fs, v)) < TOL["highest"]
    assert _rel(got, tk.kron_chain_ref([f.double() for f in fs], v.double())) < 1e-5


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    fs, v = _operands((4, 4, 8), (4, 4, 8), 1, cuda)
    before = tk.kron_matvec_slab.launches
    with pytest.raises(ValueError, match="contiguous"):
        tk.kron_matvec_slab([fs[0].T, *fs[1:]], v)
    with pytest.raises(TypeError, match="float32 factors"):
        tk.kron_matvec_slab([f.double() for f in fs], v.double())
    assert tk.kron_matvec_slab.launches == before
