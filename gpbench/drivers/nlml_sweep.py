"""A model-selection sweep: each unit is one ``log_likelihood_segmented()``
(fused CG + SLQ) at a fresh hyperparameter point (``Cell.init``).

Set-up evaluates initialisation 0; the window evaluates 1, 2, ….  The
check draws ``check_units`` of the window's evaluations from the seed and
compares each NLML with the plain reference's at the same parameters and
SLQ probes: ``nlml`` is the worst ``|NLML − NLML_ref| / |NLML_ref|``.
"""

from __future__ import annotations

from gpbench.drivers import rel_gap, sync


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.fam = cell.family
        self.done = []

    def _eval(self, i: int) -> float:
        self.fam.assign(self.model, self.cell.init(i))
        return -float(self.model.log_likelihood_segmented())

    def setup(self):
        self.model = self.cell.build()
        self._eval(0)

    def unit(self, i: int, steps: int = None) -> dict:
        nlml = self._eval(i + 1)
        sync(self.cell.device)
        self.done.append((i + 1, nlml))
        return {"steps": 1, "cg_iterations": [int(self.model.cg_iterations)]}

    def end_to_end(self, units, seconds: float) -> dict:
        return {"nlml_ms": 1e3 * seconds / len(units)}

    def free(self):
        del self.model

    def _sample(self):
        k = min(int(self.cell.traffic["check_units"]), len(self.done))
        pick = self.cell.rng(5).choice(len(self.done), size=k, replace=False)
        return [self.done[j] for j in sorted(pick)]

    def readings(self) -> dict:
        return {i: v for i, v in self._sample()}

    def reference(self, prec) -> dict:
        import torch

        cell = self.cell
        ref = self.fam.reference(cell.cfg, cell.x, cell.y, prec, cell.device)
        Z = self.fam.nlml_probes(cell.cfg, cell.model_seed, cell.device, torch.float64)
        k = int(cell.cfg["model"]["lanczos_iters"])
        return {i: ref.nlml(cell.init(i), Z, k) for i, _ in self._sample()}

    def compare(self, got, ref) -> dict:
        return {"nlml": max(rel_gap(got[i], ref[i]) for i in ref)}
