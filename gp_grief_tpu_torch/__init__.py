"""gp_grief_tpu_torch — the PyTorch/CUDA port of gp_grief_tpu.

Two paths so far:

* the closed-form GP-GRIEF model: ``InducingGrid`` → per-dimension Gram
  matrices and ``eigh`` → log-space top-p Kronecker eigenvalue selection → Φ
  assembly (kernel K1) → ΦᵀΦ / Φᵀy → O(p³) NLML → ``optimize`` → ``predict``;
* the exact grid GP ``GPKroneckerRegression``: Schur (eigen) or CG solves of
  ``⊗K_d + σ²I``, the CG matvec on kernels K2/K3, deflation preconditioning,
  mixed-precision refinement, chunked predict.

The kernels are hand-written CUDA for Hopper and run on CUDA tensors.  Models
run on the card unless built with ``device="cpu"`` (or from CPU tensors).
Module layout and public names mirror ``gp_grief_tpu``; this package imports
torch and NumPy only, never jax.

```python
import numpy as np, torch
import gp_grief_tpu_torch as gpt

x = np.random.uniform(0, 4, (1000, 1)); y = np.sin(2 * x[:, 0])
grid = gpt.InducingGrid.build(x, mbar=100)
model = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=0.5)], grid,
                         n_eigs=10, noise_var=0.5, dtype=torch.float64)  # on the card
model.optimize(max_iters=100)
mean, var = model.predict(np.linspace(0, 4, 200)[:, None])

xg = [np.linspace(0, 1, 32)[:, None]] * 3; y = np.random.randn(32**3)
grid_gp = gpt.GPKroneckerRegression(xg, y, gpt.make_kernel("rbf", lengthscale=0.2),
                                    solver="cg", cg_tol=1e-6, device="cpu")  # on the CPU
print(grid_gp.log_likelihood())
```
"""

from gp_grief_tpu_torch import convert, kernels, models, ops, optimize
from gp_grief_tpu_torch.grid import InducingGrid
from gp_grief_tpu_torch.kernels.stationary import make_kernel
from gp_grief_tpu_torch.models.gp_grief import GPGriefModel
from gp_grief_tpu_torch.models.gp_kron import GPKroneckerRegression

__all__ = [
    "InducingGrid", "make_kernel", "GPGriefModel", "GPKroneckerRegression",
    "convert", "kernels", "models", "ops", "optimize",
]
