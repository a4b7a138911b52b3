"""``GPRegression(solver="iterative")``: the matrix-free exact GP with one
RBF kernel with ARD lengthscales."""

from __future__ import annotations

import numpy as np
import torch

SCALED = ("lengthscale", "noise")


def values(cfg):
    k = cfg["kernel"]
    return {"lengthscale": np.full(cfg["d"], k["lengthscale"], np.float64),
            "variance": np.asarray(k["variance"], np.float64), "noise": np.asarray(cfg["noise_var"], np.float64)}


def build(cfg, x, y, *, seed, device):
    import gp_grief_tpu_torch as gpt

    kern = gpt.make_kernel(cfg["kernel"]["kind"], lengthscale=cfg["kernel"]["lengthscale"],
                           variance=cfg["kernel"]["variance"], input_dim=cfg["d"], dtype=torch.float32)
    return gpt.GPRegression(x, y, kern, noise_var=cfg["noise_var"], seed=seed,
                            dtype=torch.float32, device=device, **cfg["model"])


def _leaves(model):
    return {"lengthscale": model.kernel.log_lengthscale, "variance": model.kernel.log_variance,
            "noise": model.log_noise}


def assign(model, vals):
    with torch.no_grad():
        for name, p in _leaves(model).items():
            v = torch.log(torch.as_tensor(np.asarray(vals[name]), dtype=torch.float64))
            p.copy_(v.to(p.dtype).reshape(p.shape))


def read(model):
    return {k: p.detach().double().cpu().numpy() for k, p in _leaves(model).items()}


def grads(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().double().cpu().numpy()
            for k, p in _leaves(model).items()}


# The per-layer readers' solver-apply span: one Gram apply per CG iteration.
APPLY_SPAN = "gram"


def reference(cfg, x, y, prec, device):
    from gpbench.reference.exact import ExactReference

    return ExactReference(x, y, prec=prec, device=device)


def train_probes(cfg, model_seed, step, R, device, dtype):
    """The training probes: one draw for the whole fit (``(R, n)``)."""
    from gpbench.reference import rademacher, seeded_generator

    return rademacher((R, cfg["n"]), seeded_generator(model_seed, device), dtype, device)


def split(vals):
    return {k: np.asarray(v) for k, v in vals.items()}
