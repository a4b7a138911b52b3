"""Points uniform in ``[low, high]^4`` and ``y = sin(3x₀)·cos(2x₁) + ½·x₂·x₃
+ noise·N(0, 1)``: ``examples/demo_ski_1m.py``'s data (its ``f_true``)."""

import numpy as np


def f_true(x):
    return np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3]


def make(params, rng):
    n, d = int(params["n"]), int(params["d"])
    x = rng.uniform(params["low"], params["high"], size=(n, d)).astype(np.float32)
    y = (f_true(x) + params["noise"] * rng.standard_normal(n)).astype(np.float32)
    return x, y
