"""The port's multi-device layer (``gp_grief_tpu_torch.parallel``) against the
JAX package's (``gp_grief_tpu.parallel``), float64 on the CPU.

The port runs one process per rank: each test spawns gloo CPU ranks
(``parallel.launch.spawn``) that run a function of ``tests/_torch_dist_ranks.py``
(which imports no JAX), and meanwhile evaluates the JAX package's sharded
functions in this process on a mesh of the same size, cut from the 8
virtual CPU devices of ``conftest.py``.  One spawn per test function, at
the largest world: each world size is a case, run on the first ``world``
ranks (``_torch_dist_ranks.Shared``), and each spawn has its own time limit
(the launcher kills the ranks and fails the test past it).

Tolerances (relative): the stats and the GRIEF NLML and gradient 1e-10, the
Kronecker matvec 1e-12, the grid model's NLML 1e-10; the sharded port
against the single-device port 1e-10 (the sum orders differ, nothing else);
the solvers with ``group=`` against ``group=None`` 1e-10.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import gp_grief_tpu as gpx
from gp_grief_tpu import parallel as jpar
from gp_grief_tpu_torch.parallel import data_mesh, init_distributed, make_mesh
from gp_grief_tpu_torch.parallel.launch import spawn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_ranks as ranks  # noqa: E402

WORLDS = [2, 4]
GRIEF = ranks.Shared(ranks.grief, timeout=150)
SOLVERS = ranks.Shared(ranks.solvers, timeout=100)
KRON_GRID = ranks.Shared(ranks.kron_grid, timeout=180)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def jmesh(world, names=("data",), shape=None):
    return jpar.make_mesh(shape or (world,), names, devices=jax.devices()[:world])


# -- GP-GRIEF ----------------------------------------------------------------------------


def _grief_case():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (101, 2))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(101)
    x3 = rng.uniform(0, 1, (88, 3))
    y3 = np.sin(3 * x3[:, 0]) + 0.1 * rng.standard_normal(88)
    return dict(x=x, y=y, xs=rng.uniform(0, 1, (7, 2)), mbar=7, p=12, ls=0.5, log_noise=-1.0, noise_var=0.2,
                steps=3, xg3=(x3, y3, rng.uniform(0, 1, (9, 3))))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grief_matches_jax_and_single_device(world):
    case = _grief_case()
    x, y, p = case["x"], case["y"], case["p"]
    grid = gpx.InducingGrid.build(x, mbar=case["mbar"])
    xg = tuple(jnp.asarray(g) for g in grid.xg)
    kerns = [gpx.make_kernel("rbf", lengthscale=case["ls"]) for _ in range(2)]
    basis = gpx.kernels.build_basis(kerns, xg, p)
    case["basis"] = tuple([np.asarray(a) for a in t] if isinstance(t, tuple) else np.asarray(t)
                          for t in (basis.Qs, basis.lams, basis.log_lam, basis.idx))
    GRIEF.start([(w, w, case) for w in WORLDS])

    mesh = jmesh(world)
    xp, mask = jpar.pad_to_multiple(x, world)
    yp, _ = jpar.pad_to_multiple(y, world)
    xp, yp, mask = jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask)
    st = jax.jit(lambda: jpar.sharded_basis_stats(basis, kerns, xg, xp, yp, mask, mesh, n_real=len(y)))()
    params = {"kernels": kerns, "log_w": jnp.zeros(p), "log_noise": jnp.asarray(case["log_noise"])}
    nl, g = jax.jit(jax.value_and_grad(
        lambda pr: jpar.sharded_grief_nlml(pr, xg, xp, yp, mask, mesh, n_eigs=p, n_real=len(y))))(params)
    kw = dict(n_eigs=p, noise_var=case["noise_var"], dim_noise_var=1e-12, mesh=mesh)
    jm = jpar.ShardedGPGriefModel(x, y, kerns, grid, **kw)
    jm_nlml = -jm.log_likelihood()
    jm_grad = np.asarray(ravel_pytree(jax.jit(jax.grad(jm._loss))(jm.params))[0])
    x3, y3, xs3 = case["xg3"]
    grid3 = gpx.InducingGrid.build(x3, mbar=[6, 12], dims=[[0], [1, 2]])
    j3 = jpar.ShardedGPGriefModel(x3, y3, [gpx.make_kernel("rbf", lengthscale=0.6) for _ in range(2)], grid3,
                                  n_eigs=10, noise_var=0.3, dim_noise_var=1e-12, mesh=mesh)
    j3_nlml = -j3.log_likelihood()
    j3_mean, j3_var = j3.predict(xs3)

    outs = GRIEF.result(world)
    o = outs[0]
    assert o["world"] == world and len(outs) == world
    assert rel(o["C"], st.C) < 1e-10 and rel(o["v"], st.v) < 1e-10 and rel(o["yy"], st.yy) < 1e-12
    assert rel(o["fn_nlml"], nl) < 1e-10
    assert rel(o["fn_grad"]["log_w"], g["log_w"]) < 1e-10
    assert rel(o["fn_grad"]["log_noise"], g["log_noise"]) < 1e-10
    assert rel(o["fn_grad"]["ls0"], g["kernels"][0].log_lengthscale) < 1e-10
    assert rel(o["model_nlml"], jm_nlml) < 1e-10
    assert rel(o["model_grad"], jm_grad) < 1e-10
    # No world-size scaling of the gradient: the sharded gradient is the
    # single-device (world-1) one, at every world size.
    assert rel(o["model_nlml"], o["single_nlml"]) < 1e-10
    assert rel(o["model_grad"], o["single_grad"]) < 1e-10
    # Training: the same Adam steps as the single-device model, and every
    # rank holds the same parameters.
    assert np.all(np.isfinite(o["losses"])) and o["losses"][-1] < o["losses"][0]
    assert rel(o["params"], o["single_params"]) < 1e-10
    assert all(np.array_equal(oo["params"], o["params"]) for oo in outs)
    assert rel(o["mean"], o["single_mean"]) < 1e-10 and rel(o["var"], o["single_var"]) < 1e-10
    # Grouped grid dimensions through the sharded reductions.
    assert o["grouped_dims"]
    assert rel(o["grouped_nlml"], j3_nlml) < 1e-10
    assert rel(o["grouped_mean"], j3_mean) < 1e-8 and rel(o["grouped_var"], j3_var) < 1e-8
    assert np.all(np.isfinite(o["grouped_grad"])) and np.any(o["grouped_grad"] != 0)


# -- the solvers' group= ------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solvers_match_the_whole_system(world):
    rng = np.random.default_rng(1)
    n = 64
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal((3, n))
    Z = 2.0 * rng.integers(0, 2, (6, n)) - 1.0
    SOLVERS.start([(w, w, dict(A=A, b=b, Z=Z)) for w in WORLDS])
    outs = SOLVERS.result(world)
    assert len(outs) == world
    o = outs[0]
    rows = slice(*o["rows"])
    assert rel(o["cg"][0], o["cg"][1][:, rows]) < 1e-10
    assert rel(o["cg"][1], np.linalg.solve(A, b.T).T) < 1e-9
    assert o["cg_info"][0] == o["cg_info"][1]
    assert rel(o["refined"][0], o["refined"][1][:, rows]) < 1e-10
    xs, xf, its, itf = o["segments"]
    assert rel(xs, xf[:, rows]) < 1e-10 and its == itf
    assert rel(o["slq"][0], o["slq"][1]) < 1e-10
    assert rel(o["slq"][1], np.linalg.slogdet(A)[1]) < 0.05
    (a_s, b_s), (a_f, b_f) = o["lanczos"]
    assert rel(a_s, a_f) < 1e-10 and rel(b_s, b_f) < 1e-10
    xs, xf, lds, ldf, its, itf = o["fused"]
    assert rel(xs, xf[:, rows]) < 1e-10 and rel(lds, ldf) < 1e-10 and its == itf
    # Every rank read the same reduced numbers, so took the same iterations.
    assert all(oo["cg_info"] == o["cg_info"] and oo["segments"][2] == o["segments"][2] for oo in outs)
    # psum/replicate: d/dw Σ_r psum(replicate(w)·(r+1)) = Σ_r (r+1), once.
    assert all(oo["replicate_grad"] == world * (world + 1) / 2 for oo in outs)


# -- model parallelism -----------------------------------------------------------------------


def _kron_case():
    rng = np.random.default_rng(2)
    sizes = (8, 6, 4)
    fs = [rng.standard_normal((m, m)) for m in sizes]
    M = int(np.prod(sizes))
    Ks = np.stack([rng.standard_normal((8, 8)) for _ in range(6)])
    Ks = Ks @ np.transpose(Ks, (0, 2, 1)) + 8 * np.eye(8)
    xt = rng.uniform(0, 1, (64, 4))
    yt = np.sin(3 * xt[:, 0]) + 0.1 * rng.standard_normal(64)
    xg = [np.linspace(0, 1, m)[:, None] for m in sizes]
    return dict(fs=fs, v1=rng.standard_normal(M), vB=rng.standard_normal((M, 3)), Ks=Ks,
                train=dict(x=xt, y=yt, p=16), grid=dict(xg=xg, y=rng.standard_normal(M)))


@pytest.mark.parametrize("world", WORLDS)
def test_model_parallel_kron_and_grid_model_match_jax(world):
    case = _kron_case()
    KRON_GRID.start([(w, w, case) for w in WORLDS])

    mesh = jmesh(world, ("data", "model"), (world // 2, 2)) if world == 4 else jmesh(world, ("model",))
    fs = tuple(jnp.asarray(f) for f in case["fs"])
    want = {k: np.asarray(jax.jit(lambda v: jpar.kron_matvec_sharded(fs, v, mesh, axis_name="model"))(
        jnp.asarray(case[k]))) for k in ("v1", "vB")}
    g = case["grid"]
    kerns = [gpx.make_kernel("rbf", lengthscale=0.4) for _ in range(3)]
    kw = dict(noise_var=0.1, solver="cg", cg_tol=1e-12, cg_iters=400, mesh=mesh)
    jnl = {"plain": -gpx.GPKroneckerRegression(g["xg"], g["y"], kerns, **kw).log_likelihood(),
           "whiten": -gpx.GPKroneckerRegression(g["xg"], g["y"], kerns, precond_rank=16, cg_whiten=True,
                                                **kw).log_likelihood()}

    outs = KRON_GRID.result(world)
    assert len(outs) == world
    o = outs[0]
    assert o["km"] == 2
    assert rel(o["v1"][:, 0], want["v1"]) < 1e-12
    assert rel(o["vB"], want["vB"]) < 1e-12
    Qs, lams = o["eigh"]
    for i, K in enumerate(case["Ks"]):
        assert rel((Qs[i] * lams[i]) @ Qs[i].T, K) < 1e-12
    v_sh, v_lo, g_sh, g_lo = o["train"]
    assert rel(v_sh, v_lo) < 1e-10 and rel(g_sh, g_lo) < 1e-10
    for name in ("plain", "whiten", "precond"):
        (nl_sh, gr_sh), (nl_lo, gr_lo), iters = o[f"grid_{name}"]
        assert iters > 0
        assert rel(nl_sh, nl_lo) < 1e-10 and rel(gr_sh, gr_lo) < 1e-10, name
        if name in jnl:
            assert rel(nl_sh, jnl[name]) < 1e-10, name
    losses, _ = o["grid_step"]
    assert np.all(np.isfinite(losses))
    for key, msg in o["errors"].items():
        assert msg is not None and key in msg


# -- start-up and the launcher ------------------------------------------------------------


def test_init_distributed_single_process_noop(monkeypatch):
    """No arguments and no torchrun environment: touches nothing, returns 1
    (or the size of a group this process already runs)."""
    import torch.distributed as dist

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    started = dist.is_initialized()
    assert init_distributed() == (dist.get_world_size() if started else 1)
    assert dist.is_initialized() == started


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour with no CUDA device")
def test_meshes_and_launches_run_on_the_card_unless_asked_for_the_cpu():
    """Without ``device_type="cpu"`` / ``device="cpu"`` a mesh, a launch and
    the dry run raise on a host with no card, rather than running quietly
    on the CPU."""
    from gp_grief_tpu_torch.parallel.dryrun import main as dryrun_main

    for fn in (lambda: make_mesh((1,), ("data",)), lambda: data_mesh(), lambda: spawn(ranks.hang, 2),
               lambda: dryrun_main(["2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_spawn_fails_a_hung_collective_instead_of_hanging():
    with pytest.raises((TimeoutError, RuntimeError)):
        spawn(ranks.hang, 2, device="cpu", timeout=4)


def test_dryrun_multichip_on_cpu_ranks():
    """The dry run at 4 gloo ranks: the (data, model) mesh's GRIEF steps, SKI
    lattice NLML and steps (monolithic and segmented), the sharded grid NLML;
    every rank the same finite values."""
    from gp_grief_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", timeout=120)
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["grief_nlml"][1] < out["grief_nlml"][0]
    assert all(np.isfinite(out[k]) for k in ("ski_nlml", "ski_step", "ski_segmented_nlml", "grid_nlml"))
