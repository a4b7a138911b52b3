"""A model-selection sweep of the iterative NLML: :mod:`nlml_sweep`'s units
and check, each unit one
``log_likelihood_iterative_segmented(generator=…, **cfg["model"])`` (fused
CG + SLQ) at a fresh hyperparameter point, its probes drawn from a fresh
generator seeded with the model seed, so every evaluation takes the same
probes and the reference repeats them."""

from __future__ import annotations

from gpbench.drivers import nlml_sweep
from gpbench.reference import seeded_generator


class Driver(nlml_sweep.Driver):
    def _eval(self, i: int) -> float:
        self.fam.assign(self.model, self.cell.init(i))
        gen = seeded_generator(self.cell.model_seed, self.cell.device)
        return -float(self.model.log_likelihood_iterative_segmented(generator=gen, **self.cell.cfg["model"]))
