"""One client in a closed loop: each unit is one request of ``points`` test
points uniform in ``[low, high]^d``, answered by ``predict(x)`` (a mean and
an exact variance per point) at the configuration's parameters.  Each
request is timed from its issue to its synchronised return.

Set-up answers one request of its own; the check draws ``check_requests``
of the window's requests from the seed and compares their answers with the
plain reference's: ``mean`` and ``var`` are ``max |a − a_ref| / max
|a_ref|`` over the sampled points.
"""

from __future__ import annotations

import time

import numpy as np

from gpbench.drivers import rel_gap, sync


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.fam = cell.family
        self.done = []

    def _points(self, i: int, stream: int = 3) -> np.ndarray:
        t = self.cell.traffic
        rng = np.random.default_rng([self.cell.seed, stream, int(i)])
        return rng.uniform(t["low"], t["high"], size=(int(t["points"]), self.cell.cfg["d"])).astype(np.float32)

    def setup(self):
        self.model = self.cell.build()
        self.fam.assign(self.model, self.fam.values(self.cell.cfg))
        self.model.predict(self._points(0, stream=4))
        sync(self.cell.device)

    def unit(self, i: int, steps: int = None) -> dict:
        xs = self._points(i)
        t0 = time.perf_counter()
        mean, var = self.model.predict(xs)
        sync(self.cell.device)
        lat = time.perf_counter() - t0
        self.done.append((i, mean, var))
        return {"steps": 1, "points": int(xs.shape[0]), "latency_s": lat}

    def end_to_end(self, units, seconds: float) -> dict:
        lat = np.asarray([u["latency_s"] for u in units])
        return {"predict_points_per_s": sum(u["points"] for u in units) / seconds,
                "predict_p95_ms": 1e3 * float(np.percentile(lat, 95))}

    def free(self):
        del self.model

    def _sample(self):
        k = min(int(self.cell.traffic["check_requests"]), len(self.done))
        pick = self.cell.rng(5).choice(len(self.done), size=k, replace=False)
        return [self.done[j] for j in sorted(pick)]

    def readings(self) -> dict:
        s = self._sample()
        return {"idx": [i for i, _, _ in s], "mean": np.concatenate([m.double().cpu().numpy() for _, m, _ in s]),
                "var": np.concatenate([v.double().cpu().numpy() for _, _, v in s])}

    def reference(self, prec) -> dict:
        cell = self.cell
        ref = self.fam.reference(cell.cfg, cell.x, cell.y, prec, cell.device)
        xs = np.concatenate([self._points(i) for i, _, _ in self._sample()])
        mean, var = ref.predict(self.fam.values(cell.cfg), xs)
        return {"mean": mean.double().cpu().numpy(), "var": var.double().cpu().numpy()}

    def compare(self, got, ref) -> dict:
        return {"mean": rel_gap(got["mean"], ref["mean"]), "var": rel_gap(got["var"], ref["var"])}
