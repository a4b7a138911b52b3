"""The Kronecker route on the CPU: ``ops.kron_fast.kernel_route``'s Hopper
gate against the JAX package's dispatch, the folded batch identity, and the
plain version's bits.  Shapes only: zero factors, nothing launched.

Rule (a) of the gate: every product the JAX package's dispatch
(``gp_grief_tpu/ops/kron_fast.py``) sends to a Pallas kernel on a TPU goes to
K2/K3 on the card.  The oracle is the copied gates (``ops.cuda.kron``'s
``slab_schedule_applicable`` / ``fused_schedule_applicable``, held to the JAX
package's by ``test_torch_kron.py::test_routing_gates_match_jax``), applied
after ``safe_batch_pad`` where the JAX caller wraps the op in
``safe_batch_op``.  The call forms are ``chip_smoke.ROUTE_TABLE``'s (the
smoke configurations' sizes), each at num_probes 8 and 16.
"""

import math
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gp_grief_tpu.ops.batching import safe_batch_pad
from gp_grief_tpu_torch.ops.cuda import kron as tk
from gp_grief_tpu_torch.ops.kron_fast import X3, batch_identity, hopper_gate, kernel_route, kron_matvec_fast
from gp_grief_tpu_torch.parallel import sharded

# Port sites whose JAX counterpart wraps the op in safe_batch_op
# (gp_grief_tpu/models/gp_ski.py:558-560 the lattice dual, :638-746 the data
# solver's solves and SLQ).
PADDED_SITES = {"models/gp_ski.py:423", "models/gp_ski.py:314"}
# Rows whose lead is 1 + num_probes (the solves) or num_probes (SLQ).
SOLVE_ROWS = {"lattice_dual_f32", "lattice_dual_bf16", "ski_data_solve"}
SLQ_ROWS = {"lattice_slq_f32", "ski_data_slq"}
# Rows whose site also takes a bf16 vector: the grid's mixed16 CG state
# (``GPKroneckerRegression(cg_precision="mixed16")``); the lattice dual's
# train_mixed16 solves have rows of their own.
MIXED16_ROWS = {"grid_inner"}


def _call_forms():
    """The port's call forms: ROUTE_TABLE's rows with the vector dtype each
    site passes, those whose lead is a probe count at num_probes 8 and 16:
    (name, site, lead, sizes, B, precision, vector dtype)."""
    out = []
    for name, site, lead, sizes, B, precision, vdtype, _ in cs.ROUTE_TABLE:
        leads = {lead}
        if name in SOLVE_ROWS:
            leads = {9, 17}
        elif name in SLQ_ROWS:
            leads = {8, 16}
        vdtypes = [vdtype] + (["bfloat16"] if name in MIXED16_ROWS else [])
        out += [(f"{name}_lead{L}_{vd}", site, L, sizes, B, precision, getattr(torch, vd))
                for L in sorted(leads) for vd in vdtypes]
    return out


CALL_FORMS = _call_forms()


def _factors(lead, sizes, marked=True, device="cpu"):
    fs = [torch.zeros((m, m), device=device) for m in sizes]
    if lead:
        eye = batch_identity(lead, device=device) if marked else torch.eye(lead, device=device)
        fs = [eye, *fs]
    return fs


def jax_route(site, lead, sizes, B, precision, vector_dtype) -> str:
    """Where the JAX package's dispatch sends the call form on a TPU, by the
    copied gates: ``gp_grief_tpu/ops/kron_fast.py:135-212``."""
    if lead and site in PADDED_SITES:
        lead += safe_batch_pad(lead)
    fs = _factors(lead, sizes, marked=False)
    slab_ok = tk.slab_schedule_applicable(fs, B)
    if slab_ok and precision in ("default", X3):
        return "slab"
    fast = precision == "default" or vector_dtype == torch.bfloat16
    if not slab_ok and tk.fused_schedule_applicable(fs, B, fast=fast):
        return "fused"
    return "chain"


@pytest.mark.parametrize("name,site,lead,sizes,B,precision,vector_dtype", CALL_FORMS, ids=[c[0] for c in CALL_FORMS])
def test_rule_a_jax_kernels_run_kernels(name, site, lead, sizes, B, precision, vector_dtype):
    """Wherever the JAX package runs a Pallas kernel, the port runs K2/K3."""
    want = jax_route(site, lead, sizes, B, precision, vector_dtype)
    got = kernel_route(_factors(lead, sizes), B, precision, vector_dtype=vector_dtype)
    if want != "chain":
        assert got in ("slab", "fused"), f"JAX runs {want}, the port {got}"


VECTORS = (torch.float32, torch.bfloat16)
PRECISIONS = (X3, "highest", "default")


def _jax_kernel(lead, shapes, B, precision, vector_dtype) -> bool:
    """Whether the JAX package runs a Pallas kernel on ``(I_lead, *shapes)``
    with or without ``safe_batch_pad`` (a caller may wrap the op in
    ``safe_batch_op`` or not)."""
    for L in {lead, lead + safe_batch_pad(lead)} if lead else {0}:
        fs = [torch.zeros(s, device="meta") for s in shapes]
        fs = [torch.eye(L, device="meta"), *fs] if L else fs
        slab_ok = tk.slab_schedule_applicable(fs, B)
        fast = precision == "default" or vector_dtype == torch.bfloat16
        if (slab_ok and precision in ("default", X3)) or (
                not slab_ok and tk.fused_schedule_applicable(fs, B, fast=fast)):
            return True
    return False


def _assert_rule_a(lead, shapes, B):
    fs = [torch.zeros(s, device="meta") for s in shapes]
    fs = [batch_identity(lead, device="meta"), *fs] if lead else fs
    for precision in PRECISIONS:
        for vd in VECTORS:
            if _jax_kernel(lead, shapes, B, precision, vd):
                got = kernel_route(fs, B, precision, vector_dtype=vd)
                assert got in ("slab", "fused"), (lead, shapes, B, precision, vd, got)


@pytest.mark.parametrize("lead", range(1, 33))
def test_rule_a_every_lead_at_32x4(lead):
    """The lattice dual's, the data solver's and SKI predict's call form at
    every probe count up to 31 (leads 1-32), f32 and bf16 vectors, each grade."""
    _assert_rule_a(lead, [(32, 32)] * 4, 1)


# The JAX slab class at X3 with an axis of 65-1024 points (a wide pass here).
SLAB_WIDE = [(16, (128, 16, 128)), (8, (128, 128, 8)), (0, (128, 64, 16, 128)), (0, (64, 64, 2, 1024)),
             (16, (2, 64, 512, 4)), (0, (128, 128, 2, 512)), (32, (96, 128, 16)), (0, (128, 100, 8, 16))]


@pytest.mark.parametrize("lead,sizes", SLAB_WIDE)
def test_rule_a_x3_slab_shapes_with_wide_axes(lead, sizes):
    shapes = [(m, m) for m in sizes]
    if _jax_kernel(lead, shapes, 1, X3, torch.float32):
        assert kernel_route(_factors(lead, sizes), 1, X3, vector_dtype=torch.float32) != "chain"
    _assert_rule_a(lead, shapes, 1)


SWEEP_SIZES = (2, 4, 8, 16, 24, 32, 48, 64, 96, 100, 128, 256, 512, 1024, 1800, 1920)


@pytest.mark.parametrize("seed", range(8))
def test_rule_a_sweep(seed):
    """Rule (a) over seeded random products: 1-4 factors (square, or one
    rectangular), a batch identity of 0-256 rows or none, 1-128 columns."""
    rng = np.random.default_rng(seed)
    n = 0
    while n < 150:
        d = int(rng.integers(1, 5))
        ms = [int(m) for m in rng.choice(SWEEP_SIZES, size=d)]
        outs = list(ms)
        if rng.random() < 0.3:
            outs[int(rng.integers(d))] = int(rng.choice((1, 8, 96, 128, 512)))
        lead = int(rng.choice((0, 0, 2, 8, 9, 16, 17, 24, 32, 100, 256, 512)))
        B = int(rng.choice((1, 1, 1, 2, 8, 96, 128)))
        if lead * math.prod(ms) * B > 1 << 31 or math.prod(ms) * B > 1 << 31:
            continue
        _assert_rule_a(lead, list(zip(outs, ms)), B)
        n += 1


@pytest.mark.parametrize("row", cs.ROUTE_TABLE, ids=[r[0] for r in cs.ROUTE_TABLE])
def test_route_table_rules_are_the_jax_packages(row):
    """Each smoke row's rule is the oracle's: "a" exactly where the JAX
    package runs a Pallas kernel, or where the smoke holds the row to it
    (``ROUTE_HELD_TO_A``); and "a" rows route to a kernel."""
    name, site, lead, sizes, B, precision, vdtype, rule = row
    vector_dtype = getattr(torch, vdtype)
    jax_kernel = jax_route(site, lead, sizes, B, precision, vector_dtype) != "chain"
    assert rule == ("a" if jax_kernel or name in cs.ROUTE_HELD_TO_A else "b")
    assert not (jax_kernel and name in cs.ROUTE_HELD_TO_A)
    if rule == "a":
        assert kernel_route(_factors(lead, sizes), B, precision, vector_dtype=vector_dtype) != "chain"


def test_sharded_block_follows_the_whole_product():
    """A rank's share (``parallel/sharded.py``): the block ``(I_{m₁/k},
    rest)`` runs the kernel the whole product would take, the rank's rows
    folded into the plan; on a product routed to the chain, the chain."""
    v = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    grid = _factors(0, (8, 512, 512))
    block = (batch_identity(4), *grid[1:])
    assert sharded._local_route(grid, block, 1, "highest", v) == "fused"
    lattice = _factors(0, (32,) * 5)
    block = (batch_identity(16), *lattice[1:])
    assert sharded._local_route(lattice, block, 1, "highest", v) == "slab"
    small = _factors(0, (4, 4, 4))
    assert sharded._local_route(small, (batch_identity(2), *small[1:]), 1, "highest", v) is None
    cpu = types.SimpleNamespace(is_cuda=False, dtype=torch.float32)
    assert sharded._local_route(grid, (batch_identity(4), *grid[1:]), 1, "highest", cpu) is None


GATE_CASES = [  # (lead, sizes, B, precision, vector dtype, route): the measured classes
    (9, (32,) * 4, 1, X3, torch.float32, "slab"),  # the lattice dual's 1 + 8 rows
    (9, (32,) * 4, 1, "highest", torch.float32, "slab"),  # the data solver's
    (256, (32,) * 4, 1, "highest", torch.float32, "slab"),  # LOVE at rank 256
    (0, (32,) * 5, 1, "highest", torch.float32, "slab"),  # the grid's exact refresh
    (16, (32,) * 4, 1, X3, torch.bfloat16, "slab"),  # the mixed16 solves, 15 probes
    (17, (32,) * 4, 1, X3, torch.bfloat16, "slab"),  # 16 probes: JAX's chain, K2 here
    (32, (32,) * 4, 1, X3, torch.bfloat16, "slab"),  # 31 probes: JAX's slab
    (16, (128, 16, 128), 1, X3, torch.float32, "fused"),  # JAX's slab class, a wide pass
    (16, (128, 16, 128), 1, "highest", torch.float32, "chain"),  # the same at "highest": JAX's chain
    (0, (1920, 1920), 1, "highest", torch.float32, "fused"),  # the widest square factor JAX's plan takes
    (0, (32,) * 5, 1, "default", torch.bfloat16, "slab"),  # the grid's mixed16 state: JAX's slab
    (0, (8, 512, 512), 1, "highest", torch.float32, "fused"),  # JAX's exact fused class
    (8, (1024, 1024), 1, "highest", torch.float32, "fused"),  # also where K3 loses
    (0, (2048, 2048), 1, "highest", torch.float32, "chain"),  # beyond the JAX plan: the chain wins
    (4, (512, 512), 1, "highest", torch.float32, "chain"),  # under 2^21 elements
    (0, (96, 128), 1, "highest", torch.float32, "chain"),  # a wide pass at the exact grade
    (0, (96, 128), 1, "default", torch.float32, "fused"),  # the fast grade: every shape
    (0, (8, 8, 8), 1, "highest", torch.float32, "chain"),  # under 2^12 elements
    (0, (16, 16, 16), 1, "highest", torch.float32, "slab"),
    (0, (12, 24, 96), 1, "default", torch.float32, "fused"),
]


@pytest.mark.parametrize("lead,sizes,B,precision,vector_dtype,route", GATE_CASES)
def test_hopper_gate_classes(lead, sizes, B, precision, vector_dtype, route):
    assert kernel_route(_factors(lead, sizes), B, precision, vector_dtype=vector_dtype) == route


def test_route_reads_shapes_only():
    """The route and the plan read shapes and dtypes, never values: the same
    answers for factors on the meta device, and none off the card."""
    for lead, sizes, B, precision, vector_dtype, route in GATE_CASES:
        fs = _factors(lead, sizes, device="meta")
        assert kernel_route(fs, B, precision, vector_dtype=vector_dtype) == route
    assert kernel_route(_factors(9, (32,) * 4), 1, X3, vector_dtype=None) == "chain"
    assert kernel_route(_factors(9, (32,) * 4), 1, X3, vector_dtype=torch.float64) == "chain"
    assert hopper_gate((32,) * 4, (32,) * 4, 1, 9, "exact")


FOLD_CASES = [  # (lead, core factor shapes (o, m), B)
    (9, [(32, 32)] * 4, 1),
    (17, [(32, 32)] * 4, 1),
    (256, [(32, 32)] * 4, 1),
    (8, [(1024, 1024)] * 2, 1),
    (4, [(512, 512)] * 2, 1),
    (3, [(17, 20), (30, 24), (100, 96)], 2),
    (58, [(32, 32)] * 4, 1),
]


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("lead,shapes,B", FOLD_CASES)
def test_folded_plan_covers_every_axis_once(lead, shapes, B, fast):
    """The lead-folded plan contracts each of the core's axes in exactly one
    pass, never the identity: every pass's rows carry the lead, and each
    pass's output holds lead·(the lattice so far)·B elements."""
    ms, outs = tuple(m for _, m in shapes), tuple(o for o, _ in shapes)
    passes = tk._passes(ms, outs, B, lead, None, fast)
    covered = sorted(a for i, j, *_ in passes for a in range(i, j + 1))
    assert covered == list(range(len(ms)))
    cur = list(ms)
    for i, j, out_shape, _, _ in passes:
        cur[i : j + 1] = outs[i : j + 1]
        assert out_shape[0] % lead == 0
        assert math.prod(out_shape) == lead * math.prod(cur) * B
    fs = [batch_identity(lead)] + [torch.zeros(s) for s in shapes]
    assert tk.plan_takes(fs, B, fast=fast)
    assert tk.kernel_for(fs, B) == ("slab" if len(shapes) >= 3 and all(o == m <= 64 for o, m in shapes) else "fused")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lead,shapes,B", [
    (9, [(16, 16)] * 4, 1), (17, [(8, 8)] * 4, 1), (3, [(17, 20), (30, 24), (100, 96)], 2), (5, [(70, 70), (12, 12)], 1),
])
def test_folded_plain_version_is_bit_for_bit(lead, shapes, B, dtype):
    """The plain version with the batch identity folded into its rows equals
    the unfolded chain on ``(I_B, …)`` bit for bit at the exact grade (an
    identity contraction adds exact zeros), and so do K2/K3's CPU paths."""
    g = torch.Generator().manual_seed(lead)
    fs = [torch.randn(s, generator=g, dtype=torch.float64).to(torch.float32) for s in shapes]
    v = torch.randn((lead * math.prod(m for _, m in shapes), B), generator=g, dtype=torch.float64).to(dtype)
    eye, marked = torch.eye(lead), batch_identity(lead)
    want = tk.kron_chain_ref([eye, *fs], v)
    assert torch.equal(tk.kron_chain_ref([marked, *fs], v), want)
    wrapper = tk.kron_matvec_slab if tk.kernel_for([marked, *fs], B) == "slab" else tk.kron_matvec_fused
    assert torch.equal(wrapper([marked, *fs], v), want)
    fast_folded = tk.kron_chain_ref([marked, *fs], v, fast=True)
    fast_unfolded = tk.kron_chain_ref([eye, *fs], v, fast=True)
    assert torch.allclose(fast_folded, fast_unfolded, rtol=1e-2, atol=1e-2 * float(fast_unfolded.abs().max()))


def test_the_chain_and_the_cpu_keep_their_call_form():
    """On the CPU ``kron_matvec_fast`` runs the chain over ``(I_B, …)`` as
    before, the identity merged like any factor: the same bits with the
    marked identity as with ``torch.eye``; a copy of the mark is an ordinary
    matrix."""
    g = torch.Generator().manual_seed(3)
    fs = [torch.linalg.qr(torch.randn((8, 8), generator=g, dtype=torch.float64))[0] for _ in range(3)]
    v = torch.randn(9 * 8**3, generator=g, dtype=torch.float64)
    marked = batch_identity(9, dtype=torch.float64)
    for precision in ("highest", X3, "default"):
        assert torch.equal(kron_matvec_fast((marked, *fs), v, precision=precision),
                           kron_matvec_fast((torch.eye(9, dtype=torch.float64), *fs), v, precision=precision))
    assert tk.split_lead((marked, *fs))[0] == 9
    assert tk.split_lead((marked.clone(), *fs))[0] == 1
    assert tk.split_lead((marked,))[0] == 1  # a lone identity is the product itself
