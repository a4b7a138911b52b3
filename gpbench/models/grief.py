"""``GPGriefModel`` (GP-GRIEF) with one RBF kernel per dimension on a stated
Cartesian grid, evaluated by its iterative NLML."""

from __future__ import annotations

import numpy as np
import torch

SCALED = ("lengthscale", "noise")


def grid(cfg):
    g = cfg["grid"]
    return [np.linspace(g["low"], g["high"], g["points"], dtype=np.float32) for _ in range(cfg["d"])]


def values(cfg):
    d, k = cfg["d"], cfg["kernel"]
    return {"lengthscale": np.full(d, k["lengthscale"], np.float64), "variance": np.full(d, k["variance"], np.float64),
            "noise": np.asarray(cfg["noise_var"], np.float64), "w": np.full(cfg["n_eigs"], np.exp(cfg["log_w"]))}


def build(cfg, x, y, *, seed, device):
    """The model at the configuration's kernel and noise, ``log w = 0``
    (``seed`` is unused: the NLML takes its probes' generator per call)."""
    import gp_grief_tpu_torch as gpt

    xg = tuple(g[:, None] for g in grid(cfg))
    ig = gpt.InducingGrid(xg=xg, grid_shape=tuple(len(g) for g in xg), input_dim=cfg["d"], num_data=len(x),
                          dims=tuple((c,) for c in range(cfg["d"])))
    kern = [gpt.make_kernel(cfg["kernel"]["kind"], lengthscale=cfg["kernel"]["lengthscale"],
                            variance=cfg["kernel"]["variance"], input_dim=1) for _ in range(cfg["d"])]
    return gpt.GPGriefModel(x, y, kern, ig, n_eigs=cfg["n_eigs"], noise_var=cfg["noise_var"], mbar=cfg["mbar"],
                            dim_noise_var=cfg["dim_noise_var"], dtype=getattr(torch, cfg["dtype"]), device=device)


def _leaves(model):
    for d, k in enumerate(model.kernels):
        yield "lengthscale", d, k.log_lengthscale
        yield "variance", d, k.log_variance
    yield "noise", None, model.log_noise
    yield "w", None, model.log_w


def assign(model, vals):
    with torch.no_grad():
        for name, d, p in _leaves(model):
            v = np.asarray(vals[name] if d is None else vals[name][d], np.float64)
            p.copy_(torch.log(torch.as_tensor(v)).to(p.dtype).reshape(p.shape))


def read(model):
    out = {"lengthscale": [], "variance": []}
    for name, d, p in _leaves(model):
        v = p.detach().double().cpu().numpy()
        if d is None:
            out[name] = v
        else:
            out[name].append(v.reshape(()))
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


# The per-layer readers' solver-apply span: no ``gpbench/trace.py`` wrapper
# records GP-GRIEF's operator, so readers that take it find nothing.
APPLY_SPAN = "grief"


def reference(cfg, x, y, prec, device):
    from gpbench.reference.grief import GriefReference

    return GriefReference(x, y, grid(cfg), n_eigs=cfg["n_eigs"], precond_rank=cfg["model"]["precond_rank"],
                          dim_noise_var=cfg["dim_noise_var"], factor_dtype=getattr(torch, cfg["dtype"]), prec=prec,
                          device=device)


def nlml_probes(cfg, model_seed, device, dtype):
    """The NLML's SLQ probes ``(num_probes, n)``: chunks of ``probe_chunk``
    rows drawn in order from one generator seeded with ``model_seed``, as
    the fused driver draws them."""
    from gpbench.reference import rademacher, seeded_generator

    m, gen = cfg["model"], seeded_generator(model_seed, device)
    R, c = int(m["num_probes"]), max(1, min(int(m["probe_chunk"]), int(m["num_probes"])))
    return torch.cat([rademacher((min(c, R - s), cfg["n"]), gen, dtype, device) for s in range(0, R, c)])
