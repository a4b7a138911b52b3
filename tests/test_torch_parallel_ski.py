"""``ShardedGPSKIRegression`` of the port against the JAX package's, float64
on the CPU (n = 160 points in 2-D, an 8×8 lattice).

The ranks (gloo CPU processes, ``tests/_torch_dist_ranks.py:ski``) and the
JAX package's sharded model on a mesh of the same size are handed the same
NumPy probes: the JAX package's patched ``jax.random.rademacher`` gives every
shard the same block (its draw is traced once), and every rank's patched
``ops.lanczos.rademacher`` returns that block; the eigen-conventions are
``tools/ski_reference_jax.py``'s, as in ``test_torch_ski.py``.  Tolerance
1e-8 relative: the CG stops at cg_tol = 1e-10, the SLQ runs a fixed number
of steps.  At world 2 the ranks also hold the sharded model's segmented NLML,
its ``optimize_segmented`` step and its gradient to the single-device
port's on the same (tiled) probes, at 1e-8.
"""

import os
import sys

import jax
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

import gp_grief_tpu as gpx
import gp_grief_tpu.parallel.ski as jpski
from gp_grief_tpu import parallel as jpar
from tools import ski_reference_jax as ref

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_ranks as ranks  # noqa: E402

TOL = 1e-8
CASES = [("data", 2), ("data", 4), ("lattice", 2), ("lattice", 4)]
# One spawn at world 4 runs all four cases (each on its first `world` ranks).
SKI = ranks.Shared(ranks.ski, timeout=200)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


@pytest.fixture
def jax_probes(monkeypatch):
    probes = ref.NumpyProbes()
    monkeypatch.setattr(jax.random, "rademacher", probes)
    monkeypatch.setattr(jpski, "kron_eigh", ref.kron_eigh_canonical)
    monkeypatch.setattr(jpski, "top_p_kron_eigs", ref.top_p_kron_eigs_quantized)
    return probes


def _case(solver, single):
    rng = np.random.default_rng(3)
    n = 160
    x = rng.uniform(0, 2, (n, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)
    xg = [np.linspace(-0.1, 2.1, 8)[:, None]] * 2
    kw = dict(noise_var=0.2, num_probes=4, lanczos_iters=12, cg_iters=300, cg_tol=1e-10, solver=solver)
    if solver == "data":
        kw["precond_rank"] = 12
    return dict(x=x, y=y, xg=xg, xs=rng.uniform(0.1, 1.9, (9, 2)), ls=0.6, kw=kw, single=single, chunk=5)


@pytest.mark.parametrize("solver,world", CASES)
def test_sharded_ski_matches_jax(jax_probes, solver, world):
    case = _case(solver, single=world == 2)
    SKI.start([((s, w), w, _case(s, single=w == 2)) for s, w in CASES])

    mesh = jpar.make_mesh((world,), ("data",), devices=jax.devices()[:world])
    jm = jpar.ShardedGPSKIRegression(case["x"], case["y"], gpx.make_kernel("rbf", lengthscale=case["ls"]),
                                     case["xg"], mesh=mesh, **case["kw"])
    jax_probes.calls = 0
    nlml = -jm.log_likelihood()
    assert jax_probes.calls == 2  # the CG probes, then the SLQ probes
    jax_probes.calls = 0
    grad = np.asarray(ravel_pytree(jax.jit(jax.grad(jm._loss))(jm.params))[0])
    mean, var = jm.predict(case["xs"], chunk=case["chunk"])

    outs = SKI.result((solver, world))
    o = outs[0]
    assert o["world"] == world and len(outs) == world
    assert rel(o["nlml"], nlml) < TOL
    assert rel(o["grad"], grad) < TOL
    assert rel(o["mean"], mean) < TOL and rel(o["var"], var) < TOL
    assert all(rel(oo["nlml"], o["nlml"]) == 0.0 for oo in outs)
    if solver == "lattice":
        assert o["stencil"]  # K5's plain version on each rank's own rows
    if case["single"]:
        assert rel(o["nlml"], o["single_nlml"]) < TOL and rel(o["grad"], o["single_grad"]) < TOL
        assert rel(*o["seg"]) < TOL
        p_sh, p_single, loss_sh, loss_single = o["opt_seg"]
        assert rel(p_sh, p_single) < TOL and rel(loss_sh, loss_single) < TOL
        assert np.all(np.isfinite(o["opt"])) and o["opt"][-1] < o["opt"][0]
