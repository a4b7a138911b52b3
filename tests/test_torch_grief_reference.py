"""GP-GRIEF's iterative NLML against the benchmark's plain reference
(``gpbench/reference/grief.py``, plain PyTorch, nothing of the program) on
the CPU at a small size: the top-p selection, Φ and the NLML, the program in
float64 and in float32 against the reference in float64."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_grief_tpu_torch.kernels.grief import phi
from gpbench.drivers import rel_gap
from gpbench.models import grief as fam
from gpbench.reference import Precision, rademacher, seeded_generator

torch.set_num_threads(2)

CFG = json.loads((Path(__file__).resolve().parents[1] / "gpbench" / "configs" / "uci2m_grief.json").read_text())
N, D, SEED = 2000, 3, 7
# The float32 program's NLML against the float64 reference at this size
# (my CPU runs read 7.7e-8 to 5.4e-7 over the points below).
F32_LIMIT = 5e-6
F64_LIMIT = 1e-9
# Equal lengthscales on equal grids tie products exactly; each point here
# parts them, as the benchmark's sweep does.
POINTS = [{"lengthscale": [1.0, 1.1, 0.95], "noise": 0.2}, {"lengthscale": [0.7, 1.3, 0.9], "noise": 0.12},
          {"lengthscale": [1.4, 0.8, 1.1], "noise": 0.3}]


def _cfg(dtype):
    cfg = json.loads(json.dumps(CFG))
    cfg.update(n=N, d=D, n_eigs=40, dtype=dtype, grid={"points": 6, "low": -1.1, "high": 1.1})
    cfg["model"].update(precond_rank=20, cg_tol=1e-12 if dtype == "float64" else 1e-5, cg_iters=1000)
    return cfg


def _data():
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.4 * x[:, 2] + 0.1 * rng.standard_normal(N)).astype(np.float32)
    return x, y


def _values(cfg, point):
    v = fam.values(cfg)
    v["lengthscale"] = np.asarray(point["lengthscale"], np.float64)
    v["noise"] = np.asarray(point["noise"], np.float64)
    return v


def _ref(cfg, x, y):
    return fam.reference(cfg, x, y, Precision.exact(), "cpu")


@pytest.mark.parametrize("point", range(len(POINTS)))
@pytest.mark.parametrize("dtype, limit", [("float64", F64_LIMIT), ("float32", F32_LIMIT)])
def test_iterative_nlml_against_the_reference(dtype, limit, point):
    """The program's NLML (fused CG + SLQ, rank-20 whitening, probes from the
    model seed's generator) within ``limit`` of the reference's on the same
    probes."""
    cfg, (x, y) = _cfg(dtype), _data()
    model = fam.build(cfg, x, y, seed=0, device="cpu")
    vals = _values(cfg, POINTS[point])
    fam.assign(model, vals)
    got = -model.log_likelihood_iterative_segmented(generator=seeded_generator(SEED, "cpu"), **cfg["model"])
    Z = fam.nlml_probes(cfg, SEED, "cpu", torch.float64)
    want = _ref(cfg, x, y).nlml(vals, Z, int(cfg["model"]["lanczos_iters"]))
    assert rel_gap(got, want) <= limit, (got, want)


@pytest.mark.parametrize("dtype, limit", [("float64", 1e-12), ("float32", 1e-5)])
def test_basis_selection_and_phi_against_the_reference(dtype, limit):
    """The same top-p products are selected, and Φ's columns agree."""
    cfg, (x, y) = _cfg(dtype), _data()
    model = fam.build(cfg, x, y, seed=0, device="cpu")
    vals = _values(cfg, POINTS[1])
    fam.assign(model, vals)
    model.refresh_basis()
    ref = _ref(cfg, x, y)
    Q, lam, idx = ref.basis(vals)
    got = [tuple(r) for r in model._basis.idx.tolist()]
    want = [tuple(r) for r in idx.tolist()]
    assert sorted(got) == sorted(want) and len(set(got)) == cfg["n_eigs"]
    with torch.no_grad():
        P = phi(model._basis, model.kernels, model.xg, model.x, dims=model.dims).double()
    P_ref = ref.phi_all(vals, Q, lam, idx)[:, [want.index(t) for t in got]]
    assert rel_gap(P, P_ref) <= limit


def test_reference_probes_are_the_drivers_draw():
    """``nlml_probes`` repeats the fused driver's chunked draw from one
    generator: two chunks of ``probe_chunk`` rows, in order."""
    cfg = _cfg("float32")
    Z = fam.nlml_probes(cfg, 11, "cpu", torch.float32)
    gen = seeded_generator(11, "cpu")
    want = torch.cat([rademacher((4, N), gen, torch.float32, "cpu") for _ in range(2)])
    assert torch.equal(Z, want)
