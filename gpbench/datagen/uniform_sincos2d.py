"""Points uniform in ``[low, high]²`` and ``y = sin(x₀)·cos(0.7·x₁) +
noise·N(0, 1)``: the recipe of ``benchmarks/exp_r15_train500k.py``."""

import numpy as np


def make(params, rng):
    n = int(params["n"])
    x = rng.uniform(params["low"], params["high"], size=(n, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1]) + params["noise"] * rng.standard_normal(n)).astype(np.float32)
    return x, y
