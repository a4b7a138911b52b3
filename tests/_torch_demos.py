"""What the demo tests share (``tests/test_torch_demos_*.py``): the JAX
demos' values through ``tools/demos_reference_jax.py`` (once per process),
the JAX scripts' own printed lines, and the port's demos on the CPU with
``chip_smoke.DemoProbes``.

Every run uses ``chip_smoke.DEMO_CPU_ARGS``'s sizes.  The scripts print wall
times, which ``demos_reference_jax.masked`` masks.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest

import chip_smoke as cs
from tools import demos_reference_jax as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key(sizes: dict) -> tuple:
    return tuple(sorted(sizes.items()))


@functools.lru_cache(maxsize=None)
def _jax(name: str, sizes: tuple) -> dict:
    return ref.run(name, **dict(sizes))


def jax_values(name: str, **sizes) -> dict:
    """The tool's values at DEMO_CPU_ARGS (updated by ``sizes``), computed once."""
    return _jax(name, _key(sizes))


def script_argv(name: str) -> list:
    """The JAX script's command line at DEMO_CPU_ARGS's sizes (its dtype is
    its own)."""
    argv = []
    for key, value in cs.DEMO_CPU_ARGS[name].items():
        if key != "dtype":
            argv += ["--" + key.replace("_", "-"), str(value)]
    return argv


def script_stdout(name: str, argv) -> str:
    """``examples/<name>.py``'s own ``main()`` with ``sys.argv`` patched,
    inside the tool's ``patched()``; its standard output."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out, saved = io.StringIO(), sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        with ref.patched(), contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def port_module(name: str):
    return importlib.import_module(f"gp_grief_tpu_torch.examples.{name}")


def port_args(name: str, **overrides) -> dict:
    args = dict(cs.DEMO_CPU_ARGS[name], **overrides)
    if "dtype" in args:
        args["dtype"] = np.dtype(args["dtype"]).type
    return args


def port_values(name: str, block=None, **overrides) -> dict:
    """:func:`port_run`, computed once per process."""
    return _port(name, block, _key(overrides))


@functools.lru_cache(maxsize=None)
def _port(name: str, block, overrides: tuple) -> dict:
    return port_run(name, block, **dict(overrides))


@functools.lru_cache(maxsize=None)
def jax_stdout(name: str) -> str:
    """The JAX script's printed lines at DEMO_CPU_ARGS's sizes, once per process."""
    return script_stdout(name, script_argv(name))


class RankInit:
    """A spawned rank's set-up: one intra-op thread (the ranks share this
    host's cores with the other test workers) and :class:`chip_smoke.DemoProbes`."""

    def __init__(self, block=None):
        self.block = block

    def __call__(self) -> None:
        import torch

        torch.set_num_threads(1)
        cs.DemoProbes(self.block).install()


def port_run(name: str, block=None, **overrides) -> dict:
    """The port's demo on the CPU at DEMO_CPU_ARGS (updated by
    ``overrides``), every probe draw ``chip_smoke.DemoProbes``'s (in the
    spawned ranks too, through ``rank_init``)."""
    kw = port_args(name, **overrides)
    if name in ("demo_kron_grid", "demo_sharded"):
        kw["rank_init"] = RankInit(block)
    return cs.with_demo_probes(lambda: port_module(name).run(device="cpu", **kw), block)


def assert_matches(name: str, got: dict, want: dict, rtol=None) -> dict:
    """``got`` against ``want`` at DEMO_RTOL (or ``rtol``), DEMO_EQUAL exact."""
    rtol = rtol or cs.DEMO_RTOL[name]
    res = cs.demo_gaps(name, got, want)
    assert res["equal"], {k: (cs.demo_value(got, k), cs.demo_value(want, k)) for k in cs.DEMO_EQUAL.get(name, ())}
    for key, limit in rtol.items():
        assert res["gaps"][key] <= limit, f"{name}.{key}: gap {res['gaps'][key]:.3e} > {limit:.1e}"
    return res["gaps"]


def assert_record(name: str, live: dict) -> None:
    """``chip_smoke.JAX_DEMOS[name]`` is the live tool's values, at 1e-12."""

    def same(rec, val, where):
        if isinstance(rec, dict):
            assert set(rec) <= set(val), where
            for k in rec:
                same(rec[k], val[k], f"{where}[{k!r}]")
        elif isinstance(rec, list) and not all(isinstance(r, (int, float)) for r in rec):
            assert len(rec) == len(val), where
            for i, (r, v) in enumerate(zip(rec, val)):
                same(r, v, f"{where}[{i}]")
        else:
            assert rec == pytest.approx(val, rel=1e-12), where

    same(cs.JAX_DEMOS[name], live, f"JAX_DEMOS[{name!r}]")


def skeleton(lines) -> list:
    """The labels of printed lines: each line up to its first " (", every
    number replaced by ``#``, a device list by ``<devices>``."""
    out = []
    for ln in lines:
        ln = re.sub(r"^devices: .*", "devices: <devices>", ln.split(" (")[0])
        out.append(re.sub(r"-?\d[\d,]*(\.\d+)?(e[-+]\d+)?", "#", ln))
    return out


def assert_tie(name: str, values: dict) -> str:
    """The tool function is the script: the script's printed lines at the
    same sizes are the tool's values formatted by its ``lines``."""
    out = jax_stdout(name)
    assert ref.masked(out) == ref.masked("\n".join(ref.ALL[name][1](values)))
    return out


def assert_main(name: str, monkeypatch, capsys, values: dict, argv, jax_out: str, **expect) -> None:
    """The port's ``main(argv)`` calls ``run`` with ``expect`` among its
    arguments (``run`` recorded, ``values`` returned) and prints the
    script's labels."""
    module = port_module(name)
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return values

    monkeypatch.setattr(module, "run", fake_run)
    assert module.main(argv) == 0
    printed = capsys.readouterr().out
    assert skeleton(ref.masked(printed)) == skeleton(ref.masked(jax_out))
    assert {k: seen.get(k) for k in expect} == expect


def assert_main_needs_a_card(name: str) -> None:
    """Without CUDA and without ``--device cpu``, ``main`` raises."""
    import torch

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_module(name).main([])
