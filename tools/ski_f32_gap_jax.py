#!/usr/bin/env python3
"""float32-against-float64 gaps of a SKI configuration, in the JAX package and in the port.

Usage, from the repository root (CPU):
    JAX_PLATFORMS=cpu python tools/ski_f32_gap_jax.py --config ski1m_lattice --m 12 --n 20000

Builds the configuration of ``chip_smoke.SKI_CONFIGS`` at a reduced lattice
(``--m`` points a dimension, ``--n`` points) in float64 and in float32, in the
JAX package (with tools/ski_reference_jax.py's numpy probes and
eigen-conventions) and in the port (``device="cpu"``, the same probes), and
prints one JSON line: the NLML's relative gap, and the largest gap of the
predictive mean (2,000 points) and exact variance (128 points) relative to the
float64 values' largest magnitude, for each package.  chip_smoke.py holds the
card's float32 predictions to its float64 ones; this tool says whether a gap
it measures is the port's or the float32 model's, which both packages share.

For the lattice solver the line also carries ``terms``: the NLML's pieces in
each package and dtype, ``NLML = ½(quad + (n−M)·log σ² + ld_MK + ld_white +
n·log 2π)`` with ``quad = (yᵀy − 2ṽᵀγ + γᵀW̃γ)/σ²``, and ``port_f32_swapped``:
the port's float32 NLML with yᵀy summed in float32 in index order, as the JAX
package's float32 ``jnp.dot`` sums on the CPU (the port accumulates quad's
three sums in float64: ``models.gp_ski._dual_quad``); ``lanczos`` compares the SLQ
probes' Lanczos coefficients between the packages and dtypes.  The JAX package's pieces are
evaluated eagerly, op by op, with the model's own methods (its jitted loss
fuses them, which moves its float32 value by a few 1e-6 relative).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools import ski_reference_jax as ref  # noqa: E402  (sets jax to the CPU and x64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gp_grief_tpu_torch.models.gp_ski import _dual_quad  # noqa: E402


def gaps(a, b) -> dict:
    """Relative gaps of (nlml, mean, var) ``a`` from the float64 ``b``."""
    return {"nlml": abs(a[0] - b[0]) / abs(b[0]),
            "mean": float(np.abs(a[1] - b[1]).max() / np.abs(b[1]).max()),
            "var": float(np.abs(a[2] - b[2]).max() / np.abs(b[2]).max())}


def sequential_dot(a, b) -> float:
    """``Σ aᵢbᵢ`` accumulated in ``a``'s dtype in index order (NumPy's
    ``add.accumulate`` does not regroup), as XLA's CPU dot sums."""
    p = np.asarray(a) * np.asarray(b)
    return float(np.add.accumulate(p, dtype=p.dtype)[-1])


def port_terms(tm, *, sequential_yty: bool = False, probe_lanczos: bool = False) -> dict:
    """The lattice NLML of the port's model ``tm`` rebuilt from its own
    pieces (``GPSKIRegression._loss_lattice`` step by step) with chip_smoke's
    numpy probes; ``sequential_yty`` sums yᵀy as :func:`sequential_dot`.
    ``probe_lanczos`` adds the CG's final residual norms and the SLQ
    probes' Lanczos coefficients (``alpha``, ``beta``, ``num_valid``)."""
    import gp_grief_tpu_torch.ops.lanczos as tlz
    from gp_grief_tpu_torch.ops.cg import cg_solve

    o, n, M = tm._opts, tm.n, tm.M

    def run():
        with torch.no_grad():
            sigma2 = torch.exp(tm.log_noise)
            Qs, wjs, ld_MK = tm._lattice_spectra(tm._factors(), sigma2)
            to_dual, _, white = tm._make_lattice_ops(Qs, wjs)
            vt = to_dual(tm._rmatvec_bm(tm.y[None, :]))
            z = tlz.rademacher((o["num_probes"], M), dtype=tm.dtype, device=tm.device, generator=None)
            sol, info = cg_solve(white, torch.cat([vt, z], dim=0), tol=o["cg_tol"], max_iters=o["cg_iters"],
                                 layout="bm", return_info=True)
            gam = sol[0]
            if sequential_yty:
                yy = torch.tensor(sequential_dot(tm.y.cpu().numpy(), tm.y.cpu().numpy()), dtype=tm.dtype)
            else:
                yy = torch.dot(tm.y.double(), tm.y.double())
            vg, gwg = torch.dot(vt[0], gam), torch.dot(gam, white(gam[None, :])[0])
            quad = _dual_quad(yy.double(), vt[0], gam, white, sigma2)
            ld_white = tlz.slq_logdet(white, M, generator=None, num_probes=o["num_probes"],
                                      lanczos_iters=o["lanczos_iters"], dtype=tm.dtype, device=tm.device, layout="bm")
            ld = (n - M) * tm.log_noise + ld_MK + ld_white
            nlml = 0.5 * (quad + ld + n * math.log(2.0 * math.pi))
            out = {"yty": float(yy), "vt_gam": float(vg), "gam_W_gam": float(gwg), "quad": float(quad),
                   "ld_MK": float(ld_MK), "ld_white": float(ld_white), "nlml": float(nlml),
                   "cg_iterations": int(info.iterations)}
            if probe_lanczos:
                Z = torch.as_tensor(cs.ski_probe(1, (o["num_probes"], M)), dtype=tm.dtype)
                a, b, nv = tlz.lanczos_batched(white, Z, o["lanczos_iters"], layout="bm")
                out.update(cg_residual=info.residual_norm.tolist(), alpha=a.double().numpy(),
                           beta=b.double().numpy(), num_valid=nv.tolist())
        return out

    return cs.with_numpy_probes(run)


def jax_terms(jm, *, probe_lanczos: bool = False) -> dict:
    """The JAX package's lattice NLML pieces, eagerly, with its own methods
    and the numpy probes in the loss's order (call 0: CG, call 1: SLQ);
    ``probe_lanczos`` as for :func:`port_terms`."""
    from gp_grief_tpu.kernels.grid import cov_grid
    from gp_grief_tpu.ops.cg import cg_solve
    from gp_grief_tpu.ops.lanczos import lanczos_batched, slq_logdet

    ref.patch()
    o, params, n = jm._opts, jm.params, int(jm.x.shape[0])
    M = int(np.prod([int(g.shape[0]) for g in jm.xg]))
    sigma2 = jnp.exp(params["log_noise"])
    Qs, wjs, ld_MK = jm._lattice_spectra(cov_grid(params["kernels"], jm.xg, dim_noise_var=jm.dim_noise_var), sigma2)
    to_dual, _, white = jm._make_lattice_ops(Qs, wjs)
    vt = to_dual(jm._rmatvec_bm(jm.y[None, :]))
    z = jax.random.rademacher(jm._key, (o["num_probes"], M), dtype=jm.y.dtype)
    sol, info = cg_solve(white, jnp.concatenate([vt, z], axis=0), tol=o["cg_tol"], max_iters=o["cg_iters"],
                         layout="bm", implicit_diff=False, return_info=True)
    gam = sol[0]
    yy, vg, gwg = jnp.dot(jm.y, jm.y), jnp.dot(vt[0], gam), jnp.dot(gam, white(gam[None, :])[0])
    quad = (yy - 2.0 * vg + gwg) / sigma2
    ld_white = slq_logdet(white, M, key=jax.random.fold_in(jm._key, 1), num_probes=o["num_probes"],
                          lanczos_iters=o["lanczos_iters"], dtype=jm.y.dtype, layout="bm")
    ld = (n - M) * params["log_noise"] + ld_MK + ld_white
    nlml = 0.5 * (quad + ld + n * jnp.log(2.0 * jnp.pi))
    out = {"yty": float(yy), "vt_gam": float(vg), "gam_W_gam": float(gwg), "quad": float(quad),
           "ld_MK": float(ld_MK), "ld_white": float(ld_white), "nlml": float(nlml),
           "cg_iterations": int(info.iterations)}
    if probe_lanczos:
        Z = jnp.asarray(cs.ski_probe(1, (o["num_probes"], M)), dtype=jm.y.dtype)
        a, b, nv = lanczos_batched(white, Z, o["lanczos_iters"], layout="bm")
        out.update(cg_residual=np.asarray(info.residual_norm, np.float64).tolist(),
                   alpha=np.asarray(a, np.float64), beta=np.asarray(b, np.float64), num_valid=np.asarray(nv).tolist())
    return out


def lanczos_gaps(terms) -> dict:
    """Largest difference of the SLQ probes' Lanczos ``alpha`` and ``beta``,
    float32 between the packages and each package's float32 from float64,
    relative to the float64 coefficients' largest magnitude; each removed
    from ``terms``."""
    co = {(pk, tag): {k: terms[pk][tag].pop(k) for k in ("alpha", "beta")} for pk in terms for tag in terms[pk]}
    out = {}
    for k in ("alpha", "beta"):
        scale = np.abs(co["jax", "f64"][k]).max()
        out[k] = {"jax_f32_vs_port_f32": float(np.abs(co["jax", "f32"][k] - co["port", "f32"][k]).max() / scale),
                  "jax_f32_vs_f64": float(np.abs(co["jax", "f32"][k] - co["jax", "f64"][k]).max() / scale),
                  "port_f32_vs_f64": float(np.abs(co["port", "f32"][k] - co["port", "f64"][k]).max() / scale),
                  "port_f64_vs_jax_f64": float(np.abs(co["port", "f64"][k] - co["jax", "f64"][k]).max() / scale)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(cs.SKI_CONFIGS), required=True)
    ap.add_argument("--m", type=int, required=True)
    ap.add_argument("--n", type=int, required=True)
    args = ap.parse_args()
    cs.DEVICE = "cpu"
    name = args.config
    lattice = cs.SKI_CONFIGS[name]["model"]["solver"] == "lattice"
    x, y, xg = cs.ski_data(name, args.n, args.m)
    xm, xv = cs.ski_test_points(name, 2000), cs.ski_test_points(name, 128, seed=2)
    out, terms = {}, {"jax": {}, "port": {}}
    for tag, dt, tdt in (("f64", np.float64, torch.float64), ("f32", np.float32, torch.float32)):
        xd, yd, gd = x.astype(dt), y.astype(dt), [g.astype(dt) for g in xg]
        ref.patch()
        jm = ref.model(name, xd, yd, gd)
        nl = -float(jm.log_likelihood())
        mean = jm.predict(xm.astype(dt), compute_var=False)
        mean = mean[0] if isinstance(mean, tuple) else mean
        _, var = jm.predict(xv.astype(dt), variance="exact")
        out["jax", tag] = (nl, np.asarray(mean, np.float64).ravel(), np.asarray(var, np.float64))
        tm = cs.ski_model(name, xd, yd, gd, tdt)
        nl = cs.with_numpy_probes(lambda: -tm.log_likelihood())
        mean = tm.predict(xm.astype(dt), compute_var=False)
        _, var = tm.predict(xv.astype(dt))
        out["port", tag] = (nl, mean.double().numpy().ravel(), var.double().numpy())
        if lattice:
            terms["jax"][tag] = dict(jax_terms(jm, probe_lanczos=True), model_nlml=out["jax", tag][0])
            terms["port"][tag] = dict(port_terms(tm, probe_lanczos=True), model_nlml=out["port", tag][0])
            if tag == "f32":
                swapped = port_terms(tm, sequential_yty=True)
    line = {"config": name, "m": args.m, "n": args.n,
            "jax_f32_vs_f64": gaps(out["jax", "f32"], out["jax", "f64"]),
            "port_f32_vs_f64": gaps(out["port", "f32"], out["port", "f64"]),
            "port_f64_vs_jax_f64": gaps(out["port", "f64"], out["jax", "f64"])}
    if lattice:
        jax32 = out["jax", "f32"][0]
        line.update(lanczos=lanczos_gaps(terms), terms=terms, port_f32_swapped=swapped,
                    port_f32_vs_jax_f32=abs(out["port", "f32"][0] - jax32) / abs(jax32),
                    port_f32_swapped_vs_jax_f32=abs(swapped["nlml"] - jax32) / abs(jax32))
    print(json.dumps(line))


if __name__ == "__main__":
    main()
