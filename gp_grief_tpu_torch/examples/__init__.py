"""The user demos of ``examples/``, through the port.

Seven modules, named as the JAX package's scripts, each run as
``python -m gp_grief_tpu_torch.examples.<name> [--device cpu] [size arguments]``
and each exposing ``run(**args) -> dict`` (every value the demo prints,
unrounded, its wall seconds and the launches of kernels K1-K5 during the
run) and ``main(argv) -> int`` (the JAX script's lines, with its labels and
format strings):

* ``demo_1d_regression`` — GP-GRIEF and the exact GP on a noisy sine;
* ``demo_grief_highdim`` — GP-GRIEF at d = 100: an ARD phase on the kernel
  parameters, ``refresh_basis``, a reweighting polish;
* ``demo_kron_grid`` — the exact grid GP on a 40³ lattice: training,
  off-grid prediction, a grouped (2-column) grid axis, the model-parallel
  CG NLML on ``--world`` ranks;
* ``demo_sharded`` — ``ShardedGPGriefModel`` and ``ShardedGPSKIRegression``
  on ``--world`` ranks;
* ``demo_ski_mixed`` — SKI at d = 2, trained with exact and with refined
  ("mixed") CG;
* ``demo_exact_matrixfree`` — the matrix-free exact GP at n = 100,000;
* ``demo_ski_1m`` — SKI on one million points: the lattice dual, bf16
  training solves, the segmented NLML, exact predictive variances.

With no ``--device`` a demo runs the recipe of the JAX script's accelerator
branch (``--tpu``: float32 and Adam) on the card, and raises without one;
``--device cpu`` runs the script's CPU branch (float64 and L-BFGS where the
script takes them) on the CPU; ``run(recipe=...)`` picks the recipe apart
from the device.  These modules import torch, NumPy and the port only.
"""
