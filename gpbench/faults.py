"""Faults planted under the timed path, for ``gpbench.calibrate`` and the
tests that see ``correct`` come out false.  Each is a context manager that
patches the program where the fault would be made and restores it after:

- ``frozen_step``: a training step that returns its state unchanged (Adam's
  update does nothing);
- ``half_probes``: half of the probe batch left out, the mean taken over the
  rest (the second half of every probe draw repeats the first half);
- ``half_batch``: half of a request's points left out, the first half's
  answers given in their place;
- ``altered_answer``: an answer altered where it is produced (an NLML off by
  a thousandth of itself; a request's first mean moved by a hundredth of the
  largest).

The benchmark's own runs plant nothing.
"""

from __future__ import annotations

import contextlib

FAULTS = ("frozen_step", "half_probes", "half_batch", "altered_answer")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(fault, cell=None):
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; expected one of {FAULTS}")
    import torch

    from gp_grief_tpu_torch.models import gp_ski
    from gp_grief_tpu_torch.ops import lanczos

    if fault == "frozen_step":
        with _patched(torch.optim.Adam, "step", lambda self, closure=None: None):
            yield
    elif fault == "half_probes":
        draw = lanczos.rademacher

        def rademacher(shape, **kw):
            z = draw(shape, **kw)
            h = z.shape[0] // 2
            if h:
                z[h : 2 * h] = z[:h]
            return z

        with _patched(lanczos, "rademacher", rademacher):
            yield
    elif fault == "half_batch":
        predict = gp_ski.GPSKIRegression.predict

        def half(self, x, *a, **kw):
            h = (x.shape[0] + 1) // 2
            mean, var = predict(self, x[:h], *a, **kw)
            idx = torch.arange(x.shape[0], device=mean.device) % h
            return mean[idx], var[idx]

        with _patched(gp_ski.GPSKIRegression, "predict", half):
            yield
    else:
        nlml, predict = gp_ski.GPSKIRegression.log_likelihood_segmented, gp_ski.GPSKIRegression.predict

        def altered_nlml(self, *a, **kw):
            v = nlml(self, *a, **kw)
            return v + 1e-3 * abs(v)

        def altered_predict(self, *a, **kw):
            mean, var = predict(self, *a, **kw)
            mean = mean.clone()
            mean[0] += 1e-2 * torch.max(torch.abs(mean))
            return mean, var

        with _patched(gp_ski.GPSKIRegression, "log_likelihood_segmented", altered_nlml), \
                _patched(gp_ski.GPSKIRegression, "predict", altered_predict):
            yield
