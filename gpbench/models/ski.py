"""``GPSKIRegression`` (KISS-GP) with one RBF kernel per dimension on a
Cartesian lattice."""

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
            "noise": np.asarray(cfg["noise_var"], np.float64)}


def build(cfg, x, y, *, seed, device):
    import gp_grief_tpu_torch as gpt

    kern = [gpt.make_kernel(cfg["kernel"]["kind"], lengthscale=cfg["kernel"]["lengthscale"],
                            variance=cfg["kernel"]["variance"]) for _ in range(cfg["d"])]
    return gpt.GPSKIRegression(x, y, kern, [g[:, None] for g in grid(cfg)], noise_var=cfg["noise_var"],
                               train_mixed16=cfg["train_mixed16"], seed=seed, dtype=torch.float32,
                               device=device, **cfg["model"])


def _leaves(model):
    for d, k in enumerate(model.kernels):
        yield "lengthscale", d, k.log_lengthscale
        yield "variance", d, k.log_variance
    yield "noise", None, model.log_noise


def assign(model, vals):
    with torch.no_grad():
        for name, d, p in _leaves(model):
            v = vals[name] if d is None else vals[name][d]
            p.copy_(torch.log(torch.as_tensor(v, dtype=torch.float64)).to(p.dtype).reshape(p.shape))


def _collect(model, get):
    out = {"lengthscale": [], "variance": []}
    for name, d, p in _leaves(model):
        v = get(p)
        if d is None:
            out[name] = v.reshape(())
        else:
            out[name].append(v.reshape(()))
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def read(model):
    return _collect(model, lambda p: p.detach().double().cpu().numpy())


def grads(model):
    return _collect(model, lambda p: (torch.zeros_like(p) if p.grad is None else p.grad).detach().double().cpu().numpy())


# The per-layer readers' solver-apply span: one WᵀW per dual-operator apply.
APPLY_SPAN = "stencil"


def reference(cfg, x, y, prec, device):
    from gpbench.reference.ski import SKIReference

    return SKIReference(x, y, grid(cfg), prec=prec, device=device)


def lattice_size(cfg) -> int:
    return cfg["grid"]["points"] ** cfg["d"]


def train_probes(cfg, model_seed, step, R, device, dtype):
    """Training step ``step``'s probes: fresh each step, in the lattice
    dual's eigenbasis (``(R, M)``)."""
    from gpbench.reference import rademacher, seeded_generator, step_seed

    return rademacher((R, lattice_size(cfg)), seeded_generator(step_seed(model_seed, step), device), dtype, device)


def nlml_probes(cfg, model_seed, device, dtype):
    """The NLML's SLQ probes (``num_probes`` rows, one draw)."""
    from gpbench.reference import rademacher, seeded_generator

    return rademacher((cfg["model"]["num_probes"], lattice_size(cfg)), seeded_generator(model_seed, device), dtype,
                      device)


def split(vals):
    """Per-leaf arrays under the program's leaf granularity."""
    out = {}
    for k, v in vals.items():
        v = np.asarray(v)
        if v.ndim == 0:
            out[k] = v
        else:
            out.update({f"{k}.{i}": v[i] for i in range(v.shape[0])})
    return out
