"""Points uniform in ``[low, high]^d`` (d ≥ 6) and ``y = sin(2x₀)·cos(x₁) +
0.4·x₂·x₃ + tanh(x₄ + x₅) + noise·N(0, 1)``: the recipe of
``gp_grief_tpu_torch/run_configs.py``'s ``uci2m_data`` (its synthetic
``uci2m_synth``)."""

import numpy as np


def make(params, rng):
    n, d = int(params["n"]), int(params["d"])
    x = rng.uniform(params["low"], params["high"], size=(n, d)).astype(np.float32)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.4 * x[:, 2] * x[:, 3] + np.tanh(x[:, 4] + x[:, 5])
    y = (f + params["noise"] * rng.standard_normal(n)).astype(np.float32)
    return x, y
