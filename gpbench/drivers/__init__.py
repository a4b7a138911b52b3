"""Traffic drivers, one module per kind of unit, found by the ``driver`` a
traffic mix names.  Each module has a ``Driver(cell)`` with:

- ``setup()``: build the model, run the set-up units that warm every shape
  the window uses, and keep what the check of the first steps needs;
- ``unit(i, steps=None) -> dict``: one timed unit (``{"steps": …,
  "cg_iterations": […]}`` where it has them), of at most ``steps`` steps
  where a unit has several; it ends with the device idle;
- ``end_to_end(units, seconds) -> dict``: the end-to-end metrics of the
  window, by name;
- ``free()``: drop the program's state once the window has closed;
- ``readings()`` / ``reference(prec)``: what the check compares, from the
  program and from the plain reference in ``prec``'s arithmetic;
- ``compare(got, ref) -> dict``: the numbers compared, by name.

``cell`` is a :class:`Cell`.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np


@dataclass
class Cell:
    """One run's cell: its configuration and traffic (parsed JSON), the
    run's seed, the device, the data ``x``, ``y`` and the model family's
    module."""

    name: str
    cfg: dict
    traffic: dict
    seed: int
    device: str
    x: np.ndarray = None
    y: np.ndarray = None
    family: object = None

    def __post_init__(self):
        self.seed = int(self.seed) % (1 << 64)  # SeedSequence takes no negative entropy
        self.family = importlib.import_module(f"gpbench.models.{self.cfg['family']}")
        if self.x is None:
            gen = importlib.import_module(f"gpbench.datagen.{self.cfg['data']['generator']}")
            params = {**self.cfg["data"], "n": self.cfg["n"], "d": self.cfg["d"]}
            self.x, self.y = gen.make(params, np.random.default_rng([self.seed, 0]))

    @property
    def model_seed(self) -> int:
        """The seed handed to the model (its probes' generator)."""
        return int(np.random.SeedSequence([self.seed, 2]).generate_state(1)[0])

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, int(stream)])

    def build(self):
        return self.family.build(self.cfg, self.x, self.y, seed=self.model_seed, device=self.device)

    def init(self, i: int) -> dict:
        """The ``i``-th fresh initialisation: the configuration's parameters
        with each element of a rescaled leaf multiplied by a factor drawn
        log-uniformly from ``[1/s, s]``, ``s = traffic["init_spread"]``.  The
        factors come from the run's seed, or from ``traffic["init_seed"]``
        where the mix gives one: then every run takes the same sequence of
        starts, and the seed draws the data and the probes."""
        vals = self.family.values(self.cfg)
        rng = np.random.default_rng([int(self.traffic.get("init_seed", self.seed)), 1, int(i)])
        s = float(self.traffic["init_spread"])
        return {k: v * np.exp(rng.uniform(-np.log(s), np.log(s), size=np.shape(v))) if k in self.family.SCALED
                else v for k, v in vals.items()}


def sync(device: str) -> None:
    """Wait for the card (nothing on the CPU)."""
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def rel_gap(a, b) -> float:
    """``max |a − b| / max |b|``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))
