"""The port's own spans and counters (``gp_grief_tpu_torch.utils.profiling``)
on the CPU: nothing is recorded without a profiler, every span is a host
event at the profiler's ``FUNCTION`` scope, spans nest by layer and carry
their model entry's call id, the counters agree with what the solvers
report, and the numbers are the same bits with recording on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gp_grief_tpu_torch as gpt
from gp_grief_tpu_torch.ops.cg import cg_solve
from gp_grief_tpu_torch.utils import profiling

torch.set_num_threads(1)

FUNCTION, USER_SCOPE = 0, 7


def _ski():
    rng = np.random.default_rng(0)
    n, d = 1500, 3
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * rng.standard_normal(n)).astype(np.float32)
    grid = [np.linspace(-0.05, 1.05, 8, dtype=np.float32)[:, None] for _ in range(d)]
    return gpt.GPSKIRegression(x, y, [gpt.make_kernel("rbf", lengthscale=0.3) for _ in range(d)], grid,
                               noise_var=0.05, solver="lattice", num_probes=8, lanczos_iters=10, cg_tol=1e-6,
                               cg_iters=300, seed=3, dtype=torch.float32, device="cpu")


def _exact():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 8, (300, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) * np.cos(0.7 * x[:, 1]) + 0.1 * rng.standard_normal(300)).astype(np.float32)
    kern = gpt.make_kernel("rbf", lengthscale=0.8, input_dim=2, dtype=torch.float32)
    return gpt.GPRegression(x, y, kern, noise_var=0.3, solver="iterative", precond_rank=16, num_probes=4,
                            lanczos_iters=10, cg_tol=1e-5, cg_iters=100, matvec_chunk=128, seed=2,
                            dtype=torch.float32, device="cpu")


def _grief():
    """A GP-GRIEF model whose kernels changed after it was built, so that its
    first iterative NLML rebuilds the basis and the cached statistics."""
    rng = np.random.default_rng(5)
    n, d = 1200, 3
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    grid = gpt.InducingGrid.build(x, mbar=6)
    m = gpt.GPGriefModel(x, y, [gpt.make_kernel("rbf", lengthscale=ls) for ls in (1.0, 0.9, 1.2)], grid,
                         n_eigs=30, noise_var=0.2, dtype=torch.float32, device="cpu")
    m.stats_chunk = 500
    with torch.no_grad():
        m.kernels[0].log_lengthscale.add_(0.1)
    return m


# Two probe chunks of 5 fused steps leave CG to its segments.
GRIEF_ITER = dict(num_probes=4, lanczos_iters=5, cg_tol=1e-6, cg_iters=100, precond_rank=12, cg_segment_iters=10,
                  probe_chunk=2)


def _grief_nlml(m):
    return m.log_likelihood_iterative_segmented(generator=torch.Generator().manual_seed(3), **GRIEF_ITER)


XS = np.random.default_rng(2).uniform(0.05, 0.95, (16, 3)).astype(np.float32)


def _nlml(m):
    return m.log_likelihood_segmented(cg_segment_iters=20)


def _predict(m):
    return m.predict(XS)


def _train(m):
    return m.optimize_segmented(max_iters=2, cg_segment_iters=8, probe_grad_chunk=2).losses


WORK = {"nlml": (_ski, _nlml), "predict": (_ski, _predict), "train": (_exact, _train), "grief": (_grief, _grief_nlml)}


def _recorded(fn, model, **kw):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn(model)
    return out, prof, profiling.snapshot()


def _events(prof, name=None):
    return [e for e in prof.events() if e.name.startswith("gp_grief.") and (name is None or e.name == name)]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start and inner.time_range.end <= outer.time_range.end
            and inner.thread == outer.thread)


def test_off_records_nothing():
    """With no profiler running the spans and counters record nothing, and
    each span is one shared no-op."""
    profiling.reset()
    m = _ski()
    _nlml(m)
    _predict(m)
    _train(_exact())
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert (profiling.span("gp_grief.a", x=1) is profiling.span("gp_grief.b") is profiling.host_read("site")
            is profiling.site("gp_grief.c", "k")(1) is profiling.site("gp_grief.d", entry=True)())


@pytest.mark.parametrize("work", sorted(WORK))
def test_spans_are_host_events_at_function_scope(work):
    """Every ``gp_grief.*`` event is a CPU event at ``FUNCTION`` scope (no
    ``USER_SCOPE`` range, which would draw a device-side range), and the
    aggregate counts each event once."""
    make, fn = WORK[work]
    _, prof, snap = _recorded(fn, make())
    evs = _events(prof)
    assert evs
    assert {e.scope for e in evs} == {FUNCTION}
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in evs)
    for name, agg in snap["spans"].items():
        assert name.startswith("gp_grief.")
        assert agg["calls"] == len(_events(prof, name))
        assert 0.0 <= agg["self_s"] <= agg["host_s"]


@pytest.mark.parametrize("work, chain", [
    ("nlml", ("gp_grief.model.nlml", "gp_grief.cg.segment", "gp_grief.kron")),
    ("nlml", ("gp_grief.model.nlml", "gp_grief.slq.chunk", "gp_grief.stencil")),
    ("predict", ("gp_grief.model.predict", "gp_grief.model.predict.prep", "gp_grief.cg.solve", "gp_grief.kron")),
    ("predict", ("gp_grief.model.predict", "gp_grief.model.predict.chunk", "gp_grief.cg.solve",
                 "gp_grief.host_read")),
    ("train", ("gp_grief.model.step", "gp_grief.model.step.solve", "gp_grief.cg.segment", "gp_grief.gram",
               "gp_grief.gram.slab")),
    ("train", ("gp_grief.model.step", "gp_grief.model.step.grad", "gp_grief.gram.contract")),
    ("grief", ("gp_grief.model.nlml", "gp_grief.grief.prep", "gp_grief.grief.basis")),
    ("grief", ("gp_grief.model.nlml", "gp_grief.grief.prep", "gp_grief.grief.phi")),
    ("grief", ("gp_grief.model.nlml", "gp_grief.grief.prep", "gp_grief.precond.factor")),
    ("grief", ("gp_grief.model.nlml", "gp_grief.grief.prep", "gp_grief.host_read")),
    ("grief", ("gp_grief.model.nlml", "gp_grief.slq.chunk", "gp_grief.grief.apply")),
    ("grief", ("gp_grief.model.nlml", "gp_grief.cg.segment", "gp_grief.grief.apply")),
])
def test_spans_nest_by_layer(work, chain):
    """Each span of ``chain`` lies inside one of the span before it."""
    make, fn = WORK[work]
    _, prof, _ = _recorded(fn, make())
    for outer, inner in zip(chain, chain[1:]):
        outers = _events(prof, outer)
        inners = _events(prof, inner)
        assert inners and any(_inside(i, o) for i in inners for o in outers), (outer, inner)


@pytest.mark.parametrize("work", sorted(WORK))
def test_children_carry_their_entrys_call_id(work):
    """With shapes recorded, each span inside a model entry carries that
    entry's ``call`` attribute, and two entries take two ids."""
    make, fn = WORK[work]
    m = make()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn(m)
        if work != "train":
            fn(m)
    evs = _events(prof)
    entries = [e for e in evs if e.name in ("gp_grief.model.nlml", "gp_grief.model.predict", "gp_grief.model.step")]
    assert len(entries) == 2
    ids = [e.kwinputs["call"] for e in entries]
    assert len(set(ids)) == 2
    for e in evs:
        if e not in entries:
            owner = [o for o in entries if _inside(e, o)]
            assert len(owner) == 1 and e.kwinputs["call"] == owner[0].kwinputs["call"], e.name


def test_cg_iterations_counter_is_the_models():
    """The fused NLML's ``cg_iterations`` counter is the model's
    ``cg_iterations``; a request's is the iterations of both its solves."""
    m = _ski()
    _, _, snap = _recorded(_nlml, m)
    assert snap["counters"]["cg_iterations"] == m.cg_iterations > 0
    _, _, snap = _recorded(_predict, m)
    assert snap["spans"]["gp_grief.cg.solve"]["calls"] == 2
    assert snap["counters"]["host_reads"] == snap["counters"]["cg_iterations"] + 2


@pytest.mark.parametrize("layout", ["col", "bm"])
def test_a_converged_solve_reads_once_per_iteration_and_once_more(layout):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((40, 40))
    A = torch.as_tensor(A @ A.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.standard_normal((40, 3)))
    b = b if layout == "col" else b.T.contiguous()
    mv = (lambda v: A @ v) if layout == "col" else (lambda v: v @ A)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, info = cg_solve(mv, b, tol=1e-8, max_iters=200, layout=layout, return_info=True)
    snap = profiling.snapshot()
    assert 0 < info.iterations < 200
    assert snap["counters"] == {"host_reads": info.iterations + 1, "cg_iterations": info.iterations}
    assert snap["spans"]["gp_grief.host_read"]["calls"] == info.iterations + 1


@pytest.mark.parametrize("work", sorted(WORK))
def test_recording_leaves_the_numbers_as_they_were(work):
    """The NLML, the means and variances and the training losses are the
    same bits with recording on and off."""
    make, fn = WORK[work]
    off = fn(make())
    on, _, _ = _recorded(fn, make())
    off, on = (off if isinstance(off, tuple) else (off,)), (on if isinstance(on, tuple) else (on,))
    for a, b in zip(off, on):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_self_time_leaves_out_the_children():
    """A span's self time is its host time less its child spans'."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.site("gp_grief.outer", entry=True)():
            for _ in range(3):
                with profiling.span("gp_grief.inner", k=1):
                    torch.ones(100).sum()
            profiling.count("things", 2)
            profiling.count("things")
    snap = profiling.snapshot()
    outer, inner = snap["spans"]["gp_grief.outer"], snap["spans"]["gp_grief.inner"]
    assert outer["calls"] == 1 and inner["calls"] == 3 and snap["counters"] == {"things": 3}
    assert outer["self_s"] == pytest.approx(outer["host_s"] - inner["host_s"], abs=1e-9)
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_grief_counters_are_the_work_done(monkeypatch):
    """GP-GRIEF's iterative NLML: ``grief_applies`` is the solver's applies
    of the whitened operator, each one ``gp_grief.grief.apply`` span;
    ``phi_rows`` the rows of Φ assembled (the refreshed statistics' and the
    NLML's Φ, a span per chunk); the whitening check's read and the NLML's
    are host reads; and nothing is recorded without a profiler."""
    from gp_grief_tpu_torch.models import gp_grief

    applies = []
    solve = gp_grief.fused_cg_slq

    def counted(op, *a, **kw):
        return solve(lambda v: applies.append(int(v.shape[0])) or op(v), *a, **kw)

    monkeypatch.setattr(gp_grief, "fused_cg_slq", counted)
    profiling.reset()
    _grief_nlml(_grief())
    assert profiling.snapshot() == {"spans": {}, "counters": {}} and applies
    m = _grief()
    applies.clear()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        _grief_nlml(m)
    snap = profiling.snapshot()
    n, chunks = m.x.shape[0], -(-m.x.shape[0] // m.stats_chunk)
    assert snap["counters"]["grief_applies"] == len(applies) == snap["spans"]["gp_grief.grief.apply"]["calls"]
    assert sorted({e.kwinputs["B"] for e in _events(prof, "gp_grief.grief.apply")}) == sorted(set(applies))
    assert snap["counters"]["phi_rows"] == 2 * n and snap["spans"]["gp_grief.grief.phi"]["calls"] == 2 * chunks
    assert snap["counters"]["cg_iterations"] == m.cg_iterations
    for name in ("gp_grief.model.nlml", "gp_grief.grief.prep", "gp_grief.grief.basis", "gp_grief.precond.factor"):
        assert snap["spans"][name]["calls"] == 1, name
    sites = [e.kwinputs["site"] for e in _events(prof, "gp_grief.host_read")]
    assert {"precond.check_whitening", "model.nlml"} <= set(sites)
    assert snap["counters"]["host_reads"] == sum(2 if s in ("fused.chunk", "fused.segment") else 1 for s in sites)
