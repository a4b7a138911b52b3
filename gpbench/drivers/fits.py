"""Back-to-back training fits: each unit is one ``optimize_segmented`` fit of
``steps`` Adam steps from a fresh initialisation (``Cell.init``).  The
window closes at the end of the first Adam step past its length (the last
fit stops there), so that its length is quantised by a step and not by a
whole fit; the window's first fit always runs whole.

Set-up warms the model with a fit of ``warm_steps`` steps through the same
call from initialisation 0, which nothing compares; the window's fits start
from initialisations 1, 2, ….  Every whole fit of the window keeps its
losses, its first gradient and its parameters at its end.  The check draws
one of them from the seed; the plain reference takes that fit's
initialisation and probes through the same ``steps`` Adam steps, and three
numbers are compared, each by the worst leaf:

- ``loss``: each step's reported loss, ``|L − L_ref| / |L_ref|``;
- ``grad``: the first step's gradient, ``|‖g‖ − ‖g_ref‖|`` over the larger
  of the leaf's ``‖g_ref‖`` and the median leaf's;
- ``step``: the change of the parameters over the whole fit, measured the
  same way.

Leaves whose reference gradient is under a thousandth of the median leaf's
(round-off under Adam) are left out of ``grad`` and ``step``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpbench.drivers import sync
from gpbench.reference import adam_steps


class _WindowClosed(Exception):
    pass


class Driver:
    # Set by the harness: the host clock (``time.perf_counter``) at which the
    # window closes.
    stop_at = None

    def __init__(self, cell):
        self.cell = cell
        self.fam = cell.family
        self.train = dict(cell.cfg["train"])
        self.steps = int(cell.traffic["steps"])
        self.warm_steps = int(cell.traffic["warm_steps"])
        # Fit index → {"losses", "grad", "after"} of every whole fit of the window.
        self.fits = {}

    def _fit(self, i: int, steps: int, stop_at=None):
        cg, losses, grad = [], [], {}

        def callback(step, loss, info):
            cg.append(int(info["cg_iterations"]))
            losses.append(float(loss))
            if step == 0:
                grad.update(self.fam.grads(self.model))
            if stop_at is not None and time.perf_counter() >= stop_at:
                raise _WindowClosed

        self.fam.assign(self.model, self.cell.init(i))
        try:
            self.model.optimize_segmented(max_iters=steps, callback=callback, **self.train)
        except _WindowClosed:
            pass
        whole = {"losses": np.asarray(losses, np.float64), "grad": grad, "after": self.fam.read(self.model)}
        return cg, whole if len(cg) == self.steps else None

    def setup(self):
        self.model = self.cell.build()
        self._fit(0, self.warm_steps)

    def unit(self, i: int, steps: int = None) -> dict:
        cg, whole = self._fit(i + 1, steps or self.steps, stop_at=self.stop_at if self.fits else None)
        sync(self.cell.device)
        if whole is not None:
            self.fits[i + 1] = whole
        return {"steps": len(cg), "cg_iterations": cg}

    def end_to_end(self, units, seconds: float) -> dict:
        steps = sum(u["steps"] for u in units)
        return {"train_step_ms": 1e3 * seconds / steps}

    def free(self):
        del self.model

    def _checked(self) -> int:
        """The whole fit the check compares, drawn from the seed."""
        return int(self.cell.rng(5).choice(sorted(self.fits)))

    def readings(self) -> dict:
        return self.fits[self._checked()]

    def reference(self, prec) -> dict:
        cell, fam = self.cell, self.fam
        ref = fam.reference(cell.cfg, cell.x, cell.y, prec, cell.device)
        R = int(self.train.get("num_probes", cell.cfg["model"].get("num_probes", 8)))
        raw0 = {k: torch.log(torch.as_tensor(np.asarray(v, np.float64), device=cell.device))
                for k, v in cell.init(self._checked()).items()}

        def grad_fn(theta, step):
            Z = fam.train_probes(cell.cfg, cell.model_seed, step, R, cell.device, torch.float64)
            return ref.step(theta, Z)

        losses, g1, after = adam_steps(raw0, grad_fn, self.steps, float(self.train["learning_rate"]))
        np_ = lambda d: {k: v.detach().cpu().numpy() for k, v in d.items()}  # noqa: E731
        return {"losses": np.asarray(losses, np.float64), "grad": np_(g1), "after": np_(after)}

    def compare(self, got, ref) -> dict:
        split = self.fam.split
        start = split({k: np.log(np.asarray(v, np.float64)) for k, v in self.cell.init(self._checked()).items()})
        g_ref, g_got = split(ref["grad"]), split(got["grad"])
        d_ref = {k: split(ref["after"])[k] - start[k] for k in start}
        d_got = {k: split(got["after"])[k] - start[k] for k in start}
        gn = {k: float(np.linalg.norm(g_ref[k])) for k in g_ref}
        med = float(np.median(list(gn.values())))
        kept = [k for k in gn if gn[k] >= 1e-3 * med]

        def worst(a, b):
            nb = {k: float(np.linalg.norm(b[k])) for k in kept}
            mb = float(np.median(list(nb.values())))
            return max(abs(float(np.linalg.norm(a[k])) - nb[k]) / max(nb[k], mb, 1e-300) for k in kept)

        L, Lr = np.asarray(got["losses"]), np.asarray(ref["losses"])
        return {"loss": float(np.max(np.abs(L - Lr) / np.abs(Lr))), "grad": worst(g_got, g_ref),
                "step": worst(d_got, d_ref)}
