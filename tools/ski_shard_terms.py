#!/usr/bin/env python3
"""The terms of ski1m_lattice's float32 NLML on one card and sharded at world
2 (gloo, both ranks on the card), with ``chip_smoke.py`` phase 15's probes.

``quad = (yᵀy − 2ṽᵀγ + γᵀW̃γ)/σ²`` cancels its terms down to a small part of
them and divides by σ² = 0.05, so one float32 rounding of a 10⁶-term dot
moves the NLML by about 0.3 (5e-7 of it).  This prints each term of both
models (``yty``, ``vt_gam``, ``gam_white_gam``, ``ld_MK``, ``ld_white``, the
NLML), the three sums both in float32 and in float64 from the same float32
vectors (``*_f64``; the models' own ``models.gp_ski._dual_quad`` accumulates
them in float64), and their differences in NLML units, so that phase 15's
gap can be split into the float32 rounding of those sums and the rest.  It
also gives the gap as it would be with quad summed either way
(``gap_rel_f32_quad``, ``gap_rel_f64_quad``), whichever the tree ships.

Usage:  python3 tools/ski_shard_terms.py [TREE] [--seeds 0,1,2]

``TREE`` (default: this checkout) is the root of a checkout whose
``chip_smoke.py`` and ``gp_grief_tpu_torch`` it runs; run two unpacked trees
in one call to compare them on one card.  ``--seeds``: data and probe sets,
seed 0 being phase 15's; seed ``s`` draws the data from ``default_rng(s)``
(``chip_smoke.ski_data``'s draw) and the probes from ``default_rng([20261016 + s,
call])`` (``chip_smoke.ski_probe``'s draw).  One JSON line a seed, then the
card.
"""

import argparse
import json
import os
import sys
import types
from unittest import mock

_args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
_args.add_argument("tree", nargs="?", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
_args.add_argument("--seeds", default="0", help="comma-separated data and probe seeds (0: phase 15's)")
ARGS = _args.parse_args()
tree = os.path.abspath(ARGS.tree)
sys.path.insert(0, tree)

NAME = "ski1m_lattice"


def _data(cs, seed: int):
    """``cs.ski_data(NAME)`` drawn from ``default_rng(seed)`` in place of its 0."""
    import numpy as np

    draw = np.random.default_rng
    with mock.patch.object(np.random, "default_rng", lambda *a, **k: draw(seed)):
        return cs.ski_data(NAME)


def _seed_probes(cs, seed: int) -> None:
    """Point ``cs.ski_probe`` (which the probe classes call) at seed ``seed``."""
    import numpy as np

    def ski_probe(call, shape):
        rng = np.random.default_rng([20261016 + seed, call])
        return (2.0 * rng.integers(0, 2, size=shape) - 1.0).astype(np.float64)

    cs.ski_probe = ski_probe


def _recorder(model, yty) -> None:
    """Wrap ``model._lattice_objective`` to record its terms in ``model._terms``."""
    import torch

    from gp_grief_tpu_torch.models import gp_ski

    orig, terms = type(model)._lattice_objective, {}
    model._terms = terms
    f64_quad = hasattr(gp_ski, "_dual_quad")  # the tree sums quad in float64

    def objective(self, sigma2, white, vt, ld_MK, sol, z, ld_white):
        gam = sol[0]
        wg = white(gam[None, :])[0]
        s2 = float(sigma2)
        yy32, yy64 = yty(self)
        terms.update(
            yty=yy32, yty_f64=yy64,
            vt_gam=float(torch.dot(vt[0], gam)), vt_gam_f64=float(torch.dot(vt[0].double(), gam.double())),
            gam_white_gam=float(torch.dot(gam, wg)), gam_white_gam_f64=float(torch.dot(gam.double(), wg.double())),
            ld_MK=float(ld_MK), ld_white=float(ld_white), sigma2=s2)
        out = orig(self, sigma2, white, vt, ld_MK, sol, z, ld_white)
        terms["nlml"] = float(out)
        # quad both ways from the same vectors: float32 sums (the JAX
        # package's formula) and float64 ones rounded to float32 (_dual_quad).
        q32 = float((torch.as_tensor(yy32, dtype=gam.dtype) - 2.0 * torch.dot(vt[0], gam) + torch.dot(gam, wg)) / s2)
        q64 = float(torch.tensor((yy64 - 2.0 * terms["vt_gam_f64"] + terms["gam_white_gam_f64"]) / s2,
                                 dtype=gam.dtype))
        shipped = q64 if f64_quad else q32
        terms.update(quad_f32=q32, quad_f64=q64, nlml_f32_quad=terms["nlml"] + 0.5 * (q32 - shipped),
                     nlml_f64_quad=terms["nlml"] + 0.5 * (q64 - shipped))
        return out

    model._lattice_objective = types.MethodType(objective, model)


def _model_terms(model, probes) -> dict:
    import gp_grief_tpu_torch.ops.lanczos as tlz

    draw, tlz.rademacher = tlz.rademacher, probes
    try:
        model.log_likelihood()
    finally:
        tlz.rademacher = draw
    return dict(model._terms)


def rank_terms(seeds) -> list:
    """One rank: the sharded model's terms (phase 15's construction)."""
    import torch

    import chip_smoke as cs
    import gp_grief_tpu_torch as gpt
    from gp_grief_tpu_torch import parallel as par
    from gp_grief_tpu_torch.ops.collectives import psum

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.SKI_CONFIGS[NAME]
    out = []
    for seed in seeds:
        x, y, xg = _data(cs, seed)
        kerns = [gpt.make_kernel("rbf", lengthscale=cfg["lengthscale"]) for _ in range(cs.SKI_D)]
        model = par.ShardedGPSKIRegression(x, y, kerns, xg, noise_var=cfg["noise_var"], dtype=torch.float32,
                                           device="cuda", **cfg["model"])
        _recorder(model, lambda m: (float(psum(torch.dot(m.y, m.y), m.group)),
                             float(psum(torch.dot(m.y.double(), m.y.double()), m.group))))
        n_loc = int(model.x.shape[0])
        rows = slice(model.rank * n_loc, (model.rank + 1) * n_loc)
        _seed_probes(cs, seed)
        out.append(_model_terms(model, cs.RowBlockProbes(model.n_pad, rows)))
        del model
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from gp_grief_tpu_torch.parallel.launch import spawn

    if not torch.cuda.is_available():
        print("ski_shard_terms: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [int(t) for t in ARGS.seeds.split(",")]
    singles = []
    for seed in seeds:
        x, y, xg = _data(cs, seed)
        model = cs.ski_model(NAME, x, y, xg, torch.float32)
        _recorder(model, lambda m: (float(torch.dot(m.y, m.y)), float(torch.dot(m.y.double(), m.y.double()))))
        _seed_probes(cs, seed)
        singles.append(_model_terms(model, cs.NumpyProbes()))
        del model
        torch.cuda.empty_cache()
    ranks = spawn(rank_terms, 2, args=(seeds,), backend="gloo", device="cuda", timeout=1200)
    for i, (seed, single) in enumerate(zip(seeds, singles)):
        sharded = ranks[0][i]
        s2 = single["sigma2"]
        per_nlml = {"yty": 0.5 / s2, "vt_gam": -1.0 / s2, "gam_white_gam": 0.5 / s2, "ld_MK": 0.5, "ld_white": 0.5}
        diff = {k: (sharded[k] - single[k]) * w for k, w in per_nlml.items()}
        diff_f64 = {k: (sharded[k + "_f64"] - single[k + "_f64"]) * w for k, w in per_nlml.items()
                    if k + "_f64" in single}
        rounding = {k: (single[k] - single[k + "_f64"]) * w for k, w in per_nlml.items() if k + "_f64" in single}
        gap = {f"gap_rel_{q}_quad": abs(sharded[f"nlml_{q}_quad"] - single[f"nlml_{q}_quad"])
               / abs(single[f"nlml_{q}_quad"]) for q in ("f32", "f64")}
        print(json.dumps({"tree": tree, "seed": seed, "single": single, "sharded": sharded,
                          "ranks_equal": ranks[0][i] == ranks[1][i],
                          "nlml_gap_rel": abs(sharded["nlml"] - single["nlml"]) / abs(single["nlml"]), **gap,
                          "diff_in_nlml": diff, "diff_in_nlml_f64_sums": diff_f64,
                          "single_f32_rounding_in_nlml": rounding}), flush=True)
    print(cs.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
