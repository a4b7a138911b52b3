"""The reader of the program's K10 counter (``metrics/gram_fused_grads.py``):
nothing where the program keeps no such counter (a program without K10, or
one whose differentiated applies all took the slab path), the counter over
the window's steps otherwise."""

from gp_grief_tpu_torch.utils import profiling
from gpbench.metrics import gram_fused_grads


def _ctx():
    return {"units": [{"steps": 5}, {"steps": 3}]}


def test_nothing_without_the_counter(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {"gram_fused_applies": 96}})
    assert gram_fused_grads.read(_ctx()) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert gram_fused_grads.read(_ctx()) is None


def test_counter_over_steps(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counters": {"gram_fused_grads": 24}})
    assert gram_fused_grads.read(_ctx()) == 3.0
