"""gp_grief_tpu_torch — the PyTorch/CUDA port of gp_grief_tpu.

The closed-form GP-GRIEF path: ``InducingGrid`` → per-dimension Gram
matrices and ``eigh`` → log-space top-p Kronecker eigenvalue selection → Φ
assembly (kernel K1, hand-written CUDA for Hopper, on CUDA tensors) →
ΦᵀΦ / Φᵀy → O(p³) NLML → ``optimize`` → ``predict``.

Module layout and public names mirror ``gp_grief_tpu``; this package imports
torch and NumPy only, never jax.

```python
import numpy as np, torch
import gp_grief_tpu_torch as gpt

x = np.random.uniform(0, 4, (1000, 1)); y = np.sin(2 * x[:, 0])
grid = gpt.InducingGrid.build(x, mbar=100)
model = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.5)], grid,
                         n_eigs=10, noise_var=0.5, dtype=torch.float64, device="cpu")
model.optimize(max_iters=100)
mean, var = model.predict(np.linspace(0, 4, 200)[:, None])
```
"""

from gp_grief_tpu_torch import convert, kernels, models, ops, optimize
from gp_grief_tpu_torch.grid import InducingGrid
from gp_grief_tpu_torch.kernels.stationary import make_kernel
from gp_grief_tpu_torch.models.gp_grief import GPGriefModel

__all__ = ["InducingGrid", "make_kernel", "GPGriefModel", "convert", "kernels", "models", "ops", "optimize"]
