"""gp_grief_tpu_torch — the PyTorch/CUDA port of gp_grief_tpu.

Five models:

* the GP-GRIEF model: ``InducingGrid`` → per-dimension Gram matrices and
  ``eigh`` → log-space top-p Kronecker eigenvalue selection → Φ assembly
  (kernel K1) → ΦᵀΦ / Φᵀy → O(p³) NLML → ``optimize`` → ``predict``; and its
  iterative NLML, CG + SLQ on the n×n operator through one fused host driver
  (``ops.fused``);
* the exact GP ``GPRegression``: by Cholesky (the parity oracle), or by
  CG + SLQ with pivoted-Cholesky whitening on a dense or a matrix-free Gram
  (slabs rebuilt per apply: no ``(n, n)`` buffer), with BBMM training and
  matrix-free predict; its kernel a stationary or an ``extra`` kernel
  (``RatQuad``, ``Periodic``, …, ``Sum``/``Product``);
* the exact grid GP ``GPKroneckerRegression``: Schur (eigen) or CG solves of
  ``⊗K_d + σ²I``, the CG matvec on kernels K2/K3, deflation preconditioning,
  mixed-precision refinement, chunked predict;
* SKI, ``GPSKIRegression``: scattered data interpolated onto a grid, its
  log-likelihood (CG + SLQ, data-space or lattice-dual solver) and predict
  (exact and LOVE variances); ``Wᵀ`` on kernel K4, the dual's ``WᵀW`` on K5;
* ``GPweb``: the weights and noise of a weighted basis over any precomputed
  Φ (the paper's fast reweighting), from its chunked ΦᵀΦ / Φᵀy.

``parallel`` runs them over several ranks on ``torch.distributed`` (one
process per device): ``ShardedGPGriefModel`` and ``ShardedGPSKIRegression``
shard the training rows, ``GPKroneckerRegression(mesh=...)`` the lattice.

Besides the models: the structured operators and solvers (``ops``),
checkpoints, metric logs, profiling spans and finiteness guards
(``gp_grief_tpu_torch.utils``) and a command line,
``python -m gp_grief_tpu_torch {checkgrad|configs}``.

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

__version__ = "0.1.0"

from gp_grief_tpu_torch import convert, kernels, models, ops, optimize
from gp_grief_tpu_torch.grid import InducingGrid
from gp_grief_tpu_torch.kernels.extra import (
    Constant, Cosine, Linear, Periodic, Product, RatQuad, Sum, White, make_periodic, make_ratquad,
)
from gp_grief_tpu_torch.kernels.stationary import make_kernel
from gp_grief_tpu_torch.models.gp_grief import GPGriefModel
from gp_grief_tpu_torch.models.gp_kron import GPKroneckerRegression
from gp_grief_tpu_torch.models.gp_regression import GPRegression
from gp_grief_tpu_torch.models.gp_ski import GPSKIRegression
from gp_grief_tpu_torch.models.gp_web import GPweb
from gp_grief_tpu_torch import parallel  # noqa: E402  (after the models it wraps)

__all__ = [
    "InducingGrid", "make_kernel", "make_ratquad", "make_periodic", "RatQuad", "Periodic", "Cosine", "White",
    "Constant", "Linear", "Sum", "Product", "GPGriefModel", "GPKroneckerRegression", "GPRegression", "GPSKIRegression",
    "GPweb", "convert", "kernels", "models", "ops", "optimize", "parallel", "__version__",
]
