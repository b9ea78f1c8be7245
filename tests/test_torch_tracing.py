"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

A job keeps its loop spans only under ``torch.profiler``: one ``engine.run``,
a ``bsp.superstep`` a superstep with one ``bsp.enqueue`` and one
``bsp.halt_read`` inside, one ``bsp.stats_read``, all of one job.  The
counter ``host_reads`` counts the halt reads and the totals copied, with or
without a profiler.  A profiler changes no result and no counter, and the
tracing code dispatches no tensor operation.  ``partition`` keeps its phase
spans, a second job builds no plan again, and the ring counts what it
evicts.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import api as tapi  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402

ALGOS = ("hashmin", "sv")
LOOP = {"engine.run", "bsp.run", "bsp.superstep", "bsp.enqueue",
        "bsp.halt_read", "bsp.stats_read", "channels.broadcast",
        "channels.gather", "channels.gather_edges", "channels.scatter_state",
        "channels.scatter_edges", "channels.mirror", "channels.count",
        "plan.combine_with_plan", "plan.combine_sorted",
        "plan.combine_sorted_flat"}
PHASES = ("partition.assign", "partition.relabel", "partition.msg_edges",
          "partition.mirrors", "partition.pair_counts", "partition.split",
          "partition.upload")


@pytest.fixture(scope="module")
def engine():
    return tapi.Engine(backend="pallas", layout="csr", device="cpu")


@pytest.fixture(scope="module")
def pg(engine):
    g = tgen.powerlaw(800, avg_deg=6, seed=5).symmetrized()
    pg = engine.partition(g, 6, tau=12, seed=1)
    for algo in ALGOS:          # build and upload every plan the jobs use
        engine.run(algo, pg)
    return pg


def _same_totals(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def _since(n):
    return tracing.record()[n:]


def _job(engine, pg, algo, profiled):
    """One job: its result, the spans it kept, its counters' changes."""
    n0, c0 = len(tracing.record()), tracing.counters()
    if profiled:
        with profile() as prof:
            res = engine.run(algo, pg)
    else:
        prof = None
        res = engine.run(algo, pg)
    c1 = tracing.counters()
    delta = {k: v - c0.get(k, 0) for k, v in c1.items()
             if v != c0.get(k, 0)}
    return res, _since(n0), delta, prof


@pytest.mark.parametrize("algo", ALGOS)
def test_no_profiler_keeps_no_loop_span(engine, pg, algo):
    res, spans, delta, _ = _job(engine, pg, algo, False)
    assert not [s for s in spans if s.name in LOOP]
    assert delta["host_reads"] == res.n_supersteps + len(res.stats)


@pytest.mark.parametrize("algo", ALGOS)
def test_job_spans_under_the_profiler(engine, pg, algo):
    res, spans, delta, prof = _job(engine, pg, algo, True)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    (job,) = by_name["engine.run"]
    assert job.job_id == job.span_id and job.parent_id is None
    assert job.attrs["counts"]["host_reads"] == delta["host_reads"] == (
        res.n_supersteps + len(res.stats))
    steps = by_name["bsp.superstep"]
    assert len(steps) == res.n_supersteps
    assert all(a.end_ns <= b.start_ns for a, b in zip(steps, steps[1:]))
    for step in steps:
        kids = [s.name for s in spans if s.parent_id == step.span_id]
        assert sorted(kids) == ["bsp.enqueue", "bsp.halt_read"]
    assert len(by_name["bsp.stats_read"]) == 1
    assert len(by_name["bsp.run"]) == 1
    ids = {s.span_id: s for s in spans}
    for s in spans:
        assert s.job_id == job.span_id
        assert s.start_ns <= s.end_ns
        if s is not job:
            parent = ids[s.parent_id]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    summ = tracing.summary(job.start_ns, job.end_ns)
    for name, row in summ.items():
        assert row["count"] == len(by_name[name])
        assert 0 <= row["self_s"] <= row["total_s"] + 1e-12
    assert abs(summ["engine.run"]["total_s"]
               - (job.end_ns - job.start_ns) / 1e9) < 1e-9
    assert set(by_name) <= {e.name for e in prof.events()}


@pytest.mark.parametrize("algo", ALGOS)
def test_the_profiler_changes_no_result(engine, pg, algo):
    a, _, da, _ = _job(engine, pg, algo, False)
    b, _, db, _ = _job(engine, pg, algo, True)
    assert torch.equal(a.state, b.state)
    assert a.n_supersteps == b.n_supersteps
    _same_totals(a.stats, b.stats)
    assert da == db


def test_msf_counts_its_jump_reads(engine, pg):
    res, _, delta, _ = _job(engine, pg, "msf", False)
    assert res.jump_reads > 0
    assert delta["host_reads"] == (res.n_supersteps + len(res.stats)
                                   + res.jump_reads)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("profiled", [False, True])
def test_spans_dispatch_no_tensor_op(profiled):
    """Spans, counters and their readers touch no tensor: nothing they do
    reaches the dispatcher (the profiler's own range ops aside)."""
    def use():
        with tracing.span("engine.run", algo="x"):
            with tracing.span("bsp.superstep", n=0):
                tracing.count("host_reads")
            with tracing.setup_span("plan.build", kind="eg"):
                pass
            with tracing.setup_span("kernels.load", name="lib"):
                pass
            tracing.traced("channels.gather")(lambda: None)()
        tracing.record()
        tracing.counters()
        tracing.summary()
    mode = _Ops()
    if profiled:
        with profile(), mode:
            use()
    else:
        with mode:
            use()
    assert [op for op in mode.ops if not op.startswith("profiler.")] == []


def test_partition_keeps_its_phases_and_plans_are_built_once(engine):
    g = tgen.powerlaw(600, avg_deg=6, seed=9).symmetrized()
    n0 = len(tracing.record())
    pg = engine.partition(g, 4, tau=10, seed=2)
    spans = _since(n0)
    (part,) = [s for s in spans if s.name == "partition"]
    kids = [s for s in spans if s.parent_id == part.span_id]
    assert [s.name for s in kids] == list(PHASES)
    for s in kids:
        assert part.start_ns <= s.start_ns <= s.end_ns <= part.end_ns
    first = engine.run("hashmin", pg)
    built = _since(n0)
    assert {"plan.build", "plan.upload"} <= {s.name for s in built}
    n1 = len(tracing.record())
    again = engine.run("hashmin", pg)
    assert not [s for s in _since(n1)
                if s.name in ("plan.build", "plan.upload")]
    assert torch.equal(first.state, again.state)


def test_the_ring_evicts_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "_RECORD", collections.deque(maxlen=3))
    d0 = tracing.counters().get("tracing.dropped", 0)
    for i in range(5):
        with tracing.setup_span("plan.build", i=i):
            pass
    kept = tracing.record()
    assert [s.attrs["i"] for s in kept] == [2, 3, 4]
    assert tracing.counters()["tracing.dropped"] - d0 == 2


def test_summary_self_time_is_the_duration_less_the_children():
    n0 = len(tracing.record())
    with profile():
        with tracing.span("outer"):
            with tracing.span("inner"):
                np.ones(1000).sum()
            with tracing.span("inner"):
                np.ones(1000).sum()
    spans = _since(n0)
    outer = [s for s in spans if s.name == "outer"][0]
    inner = [s for s in spans if s.name == "inner"]
    summ = tracing.summary(outer.start_ns, outer.end_ns)
    dur = (outer.end_ns - outer.start_ns) / 1e9
    kids = sum(s.end_ns - s.start_ns for s in inner) / 1e9
    assert summ["inner"]["count"] == 2
    assert summ["outer"]["self_s"] == pytest.approx(dur - kids, abs=1e-9)
    assert summ["inner"]["self_s"] == pytest.approx(kids, abs=1e-9)
    assert all(s.job_id is None for s in spans)
