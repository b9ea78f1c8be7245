"""The metrics that read the program's own spans and counters, on a tiny
run of each cell on the CPU: a traced run gives each a number, the host
reads a job equal its supersteps plus its stats totals, and no plan or
kernel is built in the window; an untraced run keeps no loop span, so its
loop-span metrics give None."""
import pytest

from perfbench.harness import cell as cell_mod
from perfbench.harness import main as main_mod
from perfbench.harness import spec

SEED = 2**31 + 91
CELLS = ["lj.hashmin", "road.sv"]
LOOP = ("enqueue_ms", "halt_wait_ms", "stats_read_ms", "host_reads")
NEW = LOOP + ("plan_build_s", "window_builds")


def _run(root, name, trace, monkeypatch):
    """A tiny run of ``name``, and each job's supersteps plus stats totals
    as the program returned them."""
    from repro_torch import api
    made = []
    real = api.Engine.run

    def recording(self, algo, pg, **kw):
        res = real(self, algo, pg, **kw)
        made.append(res.n_supersteps + len(res.stats))
        return res
    monkeypatch.setattr(api.Engine, "run", recording)
    c = spec.load_cell(name, root)
    run = cell_mod.run_cell(c, SEED, 0.3, trace, "cpu")
    return c, run, made[-len(run.jobs):]


def _read(c, run, name):
    (m,) = [m for m in c.metrics_of("per_layer") if m.name == name]
    return m.reader(c.bench).read(run)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_every_new_metric(tiny_root, monkeypatch, name):
    c, run, reads = _run(tiny_root, name, True, monkeypatch)
    values = {m: _read(c, run, m) for m in NEW}
    assert all(isinstance(v, float) for v in values.values()), values
    assert values["host_reads"] == sum(reads) / len(reads)
    assert values["window_builds"] == 0
    assert values["plan_build_s"] > 0
    for m in ("enqueue_ms", "halt_wait_ms", "stats_read_ms"):
        assert values[m] > 0
    line = main_mod.result_of(run, True)["metrics"]
    assert set(NEW) <= set(line)


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_keeps_no_loop_span(tiny_root, monkeypatch, name):
    c, run, _ = _run(tiny_root, name, False, monkeypatch)
    assert {m: _read(c, run, m) for m in LOOP} == dict.fromkeys(LOOP)
    assert _read(c, run, "window_builds") == 0


def test_a_program_without_tracing_gives_none(monkeypatch):
    """A checkout whose program has no ``repro_torch.tracing``: every new
    metric gives None and none raises."""
    import sys
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    c = spec.load_cell("road.sv")
    run = cell_mod.Run(cell=c, n=1, arcs=1,
                       jobs=[cell_mod.Job(1.0, 2.0, 3, {})],
                       setup={"setup_s": 5.0}, trace=None, check={},
                       checked=0, failed=0, peak_bytes=0, device=None,
                       device_kind="cpu")
    assert {m: _read(c, run, m) for m in NEW} == dict.fromkeys(NEW)
