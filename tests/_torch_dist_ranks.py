"""Rank functions of the sharded-port tests, run by
``gp_grief_tpu_torch.parallel.launch.spawn`` in processes of their own.

This module imports torch, NumPy and the port only (never JAX), so the
spawned ranks stay free of it; the tests compare what the ranks return with
the JAX package's sharded functions, evaluated in the pytest process.  Every
function runs SPMD and returns plain NumPy values.

One launch serves several world sizes: :func:`cases` runs each case of a
rank function ``fn(case, world)`` on the first ``world`` ranks of the launch.
Every rank builds the case's meshes (a collective over the whole launch);
the ranks past ``world`` then return ``None`` for it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import gp_grief_tpu_torch as gpt
import gp_grief_tpu_torch.ops.lanczos as tlz
from gp_grief_tpu_torch import parallel as par
from gp_grief_tpu_torch.ops import collectives as coll

DEV = "cpu"


def probe(call: int, shape) -> np.ndarray:
    """The ``call``-th probe matrix of one evaluation (``chip_smoke.ski_probe``)."""
    rng = np.random.default_rng([20261016, call])
    return (2.0 * rng.integers(0, 2, size=shape) - 1.0).astype(np.float64)


class Probes:
    """Call-ordered :func:`probe` draws in place of the port's
    ``ops.lanczos.rademacher``; ``tile`` repeats each block along the rows
    (the single-device form of probes that every rank drew alike)."""

    def __init__(self, tile: int = 1):
        self.calls, self.tile = 0, tile

    def __call__(self, shape, *, dtype, device, generator):
        shape = tuple(shape)
        z = probe(self.calls, (shape[0], shape[1] // self.tile))
        self.calls += 1
        return torch.as_tensor(np.tile(z, (1, self.tile)), dtype=dtype, device=device)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _flat_grad(model):
    return np.concatenate([_np(p.grad).reshape(-1) for _, p in model._leaves()])


def _model_grad(model):
    model.zero_grad()
    loss = model._loss()
    loss.backward()
    return float(loss), _flat_grad(model)


def _kernels(ls, d):
    return [gpt.make_kernel("rbf", lengthscale=ls) for _ in range(d)]


class Shared:
    """One launch of :func:`cases` for every world-size case of a test
    function (the test side): the first case to ask starts it, each case
    reads its own ranks' results (``None`` dropped)."""

    def __init__(self, fn, timeout: float):
        self.fn, self.timeout = fn, timeout
        self._launch = self._outs = self._error = None

    def start(self, items) -> None:
        """Launch ``items`` (``(key, world, case)``) at the largest world,
        unless already launched."""
        from gp_grief_tpu_torch.parallel.launch import spawn

        if self._launch is None:
            world = max(w for _, w, _ in items)
            self._launch = spawn(cases, world, args=(self.fn, items), device=DEV, timeout=self.timeout, join=False)

    def result(self, key) -> list:
        """The ranks' results for ``key``, in rank order (raises the
        launch's error for every case if it failed)."""
        if self._outs is None and self._error is None:
            try:
                self._outs = self._launch.join()
            except Exception as e:
                self._error = e
        if self._error is not None:
            raise self._error
        return [o[key] for o in self._outs if o[key] is not None]


def cases(fn, items) -> dict:
    """``{key: fn(case, world)}`` for every ``(key, world, case)`` of
    ``items``, one after another on this launch (the collective counts
    zeroed before each)."""
    torch.set_num_threads(1)
    out = {}
    for key, world, case in items:
        coll.reset_stats()
        out[key] = fn(case, world)
    return out


# -- GP-GRIEF ----------------------------------------------------------------------


def grief(case: dict, world: int):
    """``sharded_basis_stats``, ``sharded_grief_nlml`` and its gradient, the
    sharded model (NLML, gradient, predict, Adam steps), the grouped-dims
    model and the single-device model's gradient, on ``world`` ranks."""
    x, y, xs = case["x"], case["y"], case["xs"]
    mesh = par.data_mesh(world, device_type=DEV)
    if dist.get_rank() >= world:
        return None
    grid = gpt.InducingGrid.build(x, mbar=case["mbar"])
    xg = tuple(torch.as_tensor(g) for g in grid.xg)
    p, d = case["p"], x.shape[1]
    kerns = _kernels(case["ls"], d)
    out = {"world": world}

    # The JAX package's basis (its eigenvector signs), so Φ and the stats
    # compare elementwise.
    basis = gpt.convert.basis_from_jax(*case["basis"])
    xp, mask = par.pad_to_multiple(x, world)
    yp, _ = par.pad_to_multiple(y, world)
    with torch.no_grad():
        st = par.sharded_basis_stats(basis, kerns, xg, xp, yp, mask, mesh, n_real=len(y))
    out.update(C=_np(st.C), v=_np(st.v), yy=float(st.yy))

    params = {"kernels": _kernels(case["ls"], d), "log_w": torch.zeros(p, dtype=torch.float64, requires_grad=True),
              "log_noise": torch.tensor(case["log_noise"], dtype=torch.float64, requires_grad=True)}
    nl = par.sharded_grief_nlml(params, xg, xp, yp, mask, mesh, n_eigs=p, n_real=len(y))
    nl.backward()
    out["fn_nlml"] = float(nl.detach())
    out["fn_grad"] = {"log_w": _np(params["log_w"].grad), "log_noise": float(params["log_noise"].grad),
                      "ls0": float(params["kernels"][0].log_lengthscale.grad)}

    kw = dict(n_eigs=p, noise_var=case["noise_var"], dim_noise_var=1e-12, dtype=torch.float64, device=DEV)
    sh = par.ShardedGPGriefModel(x, y, _kernels(case["ls"], d), grid, mesh=mesh, **kw)
    single = gpt.GPGriefModel(x, y, _kernels(case["ls"], d), grid, opt_kernel_params=True, **kw)
    out["model_nlml"], out["model_grad"] = _model_grad(sh)
    out["single_nlml"], out["single_grad"] = _model_grad(single)
    res = sh.optimize(optimizer="adam", max_iters=case["steps"], learning_rate=0.05)
    single.optimize(optimizer="adam", max_iters=case["steps"], learning_rate=0.05)
    out["losses"] = np.asarray(res.losses)
    out["params"], out["single_params"] = sh.parameters, single.parameters
    m, v = sh.predict(xs)
    out["mean"], out["var"] = _np(m), _np(v)
    m1, v1 = single.predict(xs)
    out["single_mean"], out["single_var"] = _np(m1), _np(v1)

    if "xg3" in case:  # grouped grid dimensions (sub_dim)
        x3, y3, xs3 = case["xg3"]
        grid3 = gpt.InducingGrid.build(x3, mbar=[6, 12], dims=[[0], [1, 2]])
        kw3 = dict(kw, n_eigs=10, noise_var=0.3)
        g3 = par.ShardedGPGriefModel(x3, y3, _kernels(0.6, 2), grid3, mesh=mesh, **kw3)
        out["grouped_dims"] = g3.dims is not None
        out["grouped_nlml"], out["grouped_grad"] = _model_grad(g3)
        m3, v3 = g3.predict(xs3)
        out["grouped_mean"], out["grouped_var"] = _np(m3), _np(v3)
    out["collectives"] = dict(coll.STATS["calls"])
    return out


# -- the solvers' group= --------------------------------------------------------------


def solvers(case: dict, world: int):
    """CG, refined CG, ``cg_segments``, Lanczos, SLQ and the fused driver on a
    row-sharded SPD system (every rank its block of rows), against the same
    calls with ``group=None`` on the whole system in this process."""
    from gp_grief_tpu_torch.ops import fused
    from gp_grief_tpu_torch.ops.cg import cg_segments, cg_solve, cg_solve_refined

    mesh = par.data_mesh(world, device_type=DEV)
    if dist.get_rank() >= world:
        return None
    group = mesh.get_group("data")
    rank = coll.axis_index(mesh, "data")
    A, b, Z = (torch.as_tensor(case[k]) for k in ("A", "b", "Z"))
    n = A.shape[0]
    nl = n // world
    rows = slice(rank * nl, (rank + 1) * nl)

    def mv_bm(vl):  # (B, n_loc) rows → this rank's rows of A·v
        full = coll.all_gather(vl.T.contiguous(), group).T
        return (full @ A.T)[:, rows]

    def mv_full(v):
        return v @ A.T

    out = {}
    kw = dict(tol=1e-12, max_iters=300, layout="bm")
    with torch.no_grad():
        out["cg"] = (_np(cg_solve(mv_bm, b[:, rows], group=group, **kw)), _np(cg_solve(mv_full, b, **kw)))
        out["cg_info"] = (cg_solve(mv_bm, b[:, rows], group=group, return_info=True, **kw)[1].iterations,
                          cg_solve(mv_full, b, return_info=True, **kw)[1].iterations)
        rk = dict(tol=1e-10, inner_iters=20, max_restarts=10, layout="bm", implicit_diff=False)
        out["refined"] = (_np(cg_solve_refined(mv_bm, mv_bm, b[:, rows], group=group, **rk)),
                          _np(cg_solve_refined(mv_full, mv_full, b, **rk)))
        sk = dict(tol=1e-12, max_iters=300, segment_iters=7)
        xs, its = cg_segments(mv_bm, b[:, rows], group=group, **sk)
        xf, itf = cg_segments(mv_full, b, **sk)
        out["segments"] = (_np(xs), _np(xf), its, itf)

        class Draw:  # successive probes of Z, this rank's rows of them when sharded
            def __init__(self):
                self.at = 0

            def __call__(self, shape, *, dtype, device, generator):
                z = Z[self.at : self.at + shape[0]]
                self.at += shape[0]
                return (z[:, rows] if shape[1] == nl else z).to(dtype)

        tlz.rademacher = Draw()
        lk = dict(num_probes=Z.shape[0], lanczos_iters=25, dtype=torch.float64, layout="bm", generator=None)
        ld_s = float(tlz.slq_logdet(mv_bm, nl, group=group, **lk))
        tlz.rademacher = Draw()
        out["slq"] = (ld_s, float(tlz.slq_logdet(mv_full, n, **lk)))
        res_s = tlz.lanczos(lambda q: mv_bm(q.T).T, b[0, rows], 12, group=group)
        res_f = tlz.lanczos(lambda q: mv_full(q.T).T, b[0], 12)
        out["lanczos"] = ((_np(res_s.alpha), _np(res_s.beta)), (_np(res_f.alpha), _np(res_f.beta)))
        fk = dict(num_probes=Z.shape[0], lanczos_iters=20, probe_chunk=3, cg_tol=1e-10, cg_iters=200,
                  cg_segment_iters=10, generator=None)
        tlz.rademacher = Draw()
        xs, lds, its = fused.fused_cg_slq(mv_bm, b[:1, rows], group=group, **fk)
        tlz.rademacher = Draw()
        xf, ldf, itf = fused.fused_cg_slq(mv_full, b[:1], **fk)
        out["fused"] = (_np(xs), _np(xf), lds, ldf, its, itf)
    out["rows"] = (rows.start, rows.stop)
    w = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    coll.psum(coll.replicate(w, group) * (rank + 1), group).backward()
    out["replicate_grad"] = float(w.grad)
    return out


# -- model parallelism: the sharded Kronecker matvec and the grid model ----------------


def kron_grid(case: dict, world: int):
    """``kron_matvec_sharded`` (1-D mesh at world 2, the ``model`` axis of a
    (2, 2) mesh at world 4), ``stacked_eigh_sharded`` and the 2-D mesh's
    training step, and ``GPKroneckerRegression(mesh=)``: NLML, gradient, one
    Adam step, the constructor's guards."""
    from gp_grief_tpu_torch.kernels.grid import cov_grid
    from gp_grief_tpu_torch.kernels.grief import GriefBasis, build_basis, phi
    from gp_grief_tpu_torch.models.base import BasisStats, basis_nlml
    from gp_grief_tpu_torch.ops.topk import top_p_kron_eigs

    if world == 4:
        mesh = dm = par.make_mesh((world // 2, 2), ("data", "model"), device_type=DEV)
    else:
        mesh = par.make_mesh((world,), ("model",), device_type=DEV)
        dm = par.make_mesh((world,), ("data",), device_type=DEV)
    if dist.get_rank() >= world:
        return None
    km = coll.axis_size(mesh, "model")
    j = coll.axis_index(mesh, "model")
    out = {"world": world, "km": km}
    fs = tuple(torch.as_tensor(f) for f in case["fs"])
    for key in ("v1", "vB"):
        v = torch.as_tensor(case[key])
        blk = v.shape[0] // km
        got = par.kron_matvec_sharded(fs, v[j * blk : (j + 1) * blk], mesh, axis_name="model")
        out[key] = _np(coll.all_gather(got if got.ndim == 2 else got[:, None], mesh.get_group("model")))

    Ks = torch.as_tensor(case["Ks"])
    Qs, lams = par.stacked_eigh_sharded(Ks, mesh, "model")
    out["eigh"] = (_np(Qs), _np(lams))

    # The whole training step on the mesh: split eigh + sharded stats.
    t = case["train"]
    x, y = t["x"], t["y"]
    d, p = x.shape[1], t["p"]
    grid = gpt.InducingGrid.build(x, mbar=8)
    xg = tuple(torch.as_tensor(g) for g in grid.xg)
    xp, mask = par.pad_to_multiple(x, coll.axis_size(dm, "data"))
    yp, _ = par.pad_to_multiple(y, coll.axis_size(dm, "data"))

    def params():
        return {"kernels": _kernels(0.4, d), "log_w": torch.zeros(p, dtype=torch.float64, requires_grad=True),
                "log_noise": torch.tensor(-1.0, dtype=torch.float64, requires_grad=True)}

    def grads(pr):
        return np.concatenate([_np(k.log_lengthscale.grad).reshape(-1) for k in pr["kernels"]]
                              + [_np(k.log_variance.grad).reshape(-1) for k in pr["kernels"]]
                              + [_np(pr["log_w"].grad), _np(pr["log_noise"].grad).reshape(-1)])

    ps = params()
    Ks_t = torch.stack(cov_grid(ps["kernels"], xg, dim_noise_var=1e-10))
    Qst, lamst = par.stacked_eigh_sharded(Ks_t, mesh, "model")
    lam_t = tuple(lamst[i] for i in range(d))
    log_lam, idx = top_p_kron_eigs(lam_t, p)
    basis = GriefBasis(Qs=tuple(Qst[i] for i in range(d)), lams=lam_t, log_lam=log_lam, idx=idx)
    st = par.sharded_basis_stats(basis, ps["kernels"], xg, xp, yp, mask, dm, n_real=len(y))
    v_sh = basis_nlml(st, ps["log_w"], ps["log_noise"])
    v_sh.backward()
    pl = params()
    bl = build_basis(pl["kernels"], xg, p, dim_noise_var=1e-10)
    Phi = phi(bl, pl["kernels"], xg, torch.as_tensor(x))
    yt = torch.as_tensor(y)
    v_lo = basis_nlml(BasisStats(C=Phi.T @ Phi, v=Phi.T @ yt, yy=torch.dot(yt, yt), n=len(y)),
                      pl["log_w"], pl["log_noise"])
    v_lo.backward()
    out["train"] = (float(v_sh), float(v_lo), grads(ps), grads(pl))

    g = case["grid"]
    kerns = _kernels(0.4, 3)
    for name, kw in (("plain", {}), ("whiten", dict(precond_rank=16, cg_whiten=True)),
                     ("precond", dict(precond_rank=16, cg_whiten=False))):
        kwm = dict(noise_var=0.1, solver="cg", cg_tol=1e-12, cg_iters=400, device=DEV, **kw)
        par_m = gpt.GPKroneckerRegression(g["xg"], g["y"], kerns, mesh=mesh, **kwm)
        loc = gpt.GPKroneckerRegression(g["xg"], g["y"], kerns, **kwm)
        out[f"grid_{name}"] = (_model_grad(par_m), _model_grad(loc), par_m.cg_info.iterations)
    par_m = gpt.GPKroneckerRegression(g["xg"], g["y"], kerns, mesh=mesh, noise_var=0.1, solver="cg", cg_tol=1e-12,
                                      cg_iters=400, device=DEV)
    res = par_m.optimize(max_iters=2, optimizer="adam", learning_rate=0.05)
    out["grid_step"] = (np.asarray(res.losses), par_m.parameters)
    errs = {}
    bad = [np.linspace(0, 1, 7)[:, None]] + list(g["xg"][1:])
    for key, fn in (("divisible", lambda: gpt.GPKroneckerRegression(bad, np.zeros(7 * 6 * 4), kerns, mesh=mesh,
                                                                     solver="cg", device=DEV)),
                    ("no axis", lambda: gpt.GPKroneckerRegression(g["xg"], g["y"], kerns, mesh=mesh, solver="cg",
                                                                   model_axis="nope", device=DEV)),
                    ("solver='cg'", lambda: gpt.GPKroneckerRegression(g["xg"], g["y"], kerns, mesh=mesh,
                                                                       solver="schur", device=DEV))):
        try:
            fn()
            errs[key] = None
        except ValueError as e:
            errs[key] = str(e)
    out["errors"] = errs
    out["collectives"] = dict(coll.STATS["calls"])
    return out


# -- SKI -------------------------------------------------------------------------------


def ski(case: dict, world: int):
    """``ShardedGPSKIRegression``: NLML, gradient and predict with the probes
    of :func:`probe` (the same block on every rank, as the JAX package's
    patched draw gives every shard), then, with ``single``, the single-device
    port on the tiled probes: NLML, ``log_likelihood_segmented`` and one
    ``optimize_segmented`` / ``optimize`` step each."""
    mesh = par.data_mesh(world, device_type=DEV)
    if dist.get_rank() >= world:
        return None
    x, y, xg, xs = case["x"], case["y"], case["xg"], case["xs"]
    kw = dict(case["kw"], device=DEV)
    out = {"world": world}

    def make(cls, **extra):
        k = gpt.make_kernel("rbf", lengthscale=case["ls"])
        return cls(x, y, [k] * len(xg), xg, **kw, **extra)

    sh = make(par.ShardedGPSKIRegression, mesh=mesh)
    tlz.rademacher = Probes()
    out["nlml"], out["grad"] = _model_grad(sh)
    m, v = sh.predict(xs, chunk=case.get("chunk", 0))
    out["mean"], out["var"] = _np(m), _np(v)
    if kw.get("solver") == "lattice":
        out["stencil"] = sh._wtw_stencil is not None
    if case.get("single"):
        lattice = kw.get("solver") == "lattice"
        tile = 1 if lattice else world
        single = make(gpt.GPSKIRegression)
        tlz.rademacher = Probes(tile)
        out["single_nlml"], out["single_grad"] = _model_grad(single)
        sk = dict(cg_segment_iters=15, probe_chunk=2)
        tlz.rademacher = Probes()
        seg = sh.log_likelihood_segmented(**sk)
        tlz.rademacher = Probes(tile)
        out["seg"] = (seg, single.log_likelihood_segmented(**sk))
        ok = dict(max_iters=1, learning_rate=0.05, num_probes=2, cg_segment_iters=15)
        tlz.rademacher = Probes()
        res = sh.optimize_segmented(**ok)
        tlz.rademacher = Probes(tile)
        res1 = single.optimize_segmented(**ok)
        out["opt_seg"] = (sh.parameters, single.parameters, float(res.losses[0]), float(res1.losses[0]))
        tlz.rademacher = Probes()
        r2 = sh.optimize(optimizer="adam", max_iters=2, learning_rate=0.05)
        out["opt"] = np.asarray(r2.losses)
    out["collectives"] = dict(coll.STATS["calls"])
    return out


# -- the dry run and the launcher's guards ----------------------------------------------


def hang() -> None:
    """Rank 0 waits in a collective that rank 1 never joins."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    else:
        import time

        time.sleep(600)
