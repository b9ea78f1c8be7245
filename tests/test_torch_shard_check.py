"""Port: ``python -m repro_torch.launch.shard_check`` against the JAX
package's launcher and single-device engine.

* ``_parse_devices`` and ``_suite_cells`` equal the reference's (whose
  module imports no JAX).
* ``--suite tier1 --device cpu`` runs once in a subprocess (a
  spawn of 2 gloo ranks and one of 8): exit 0, every cell of the suite
  OK, every gate true (``check_all_to_all``, ``check_routed_memory``,
  ``check_masked_lanes``, ``check_hier_levels``, ``check_hier_caps``,
  ``check_gspmm_hier`` at F=4 and F=1) and every control rejected by its
  gate: a step that all-gathers the (m_loc, n_loc) state fails the
  routed-memory predicate, as does a step with no collective (a gate
  never passes vacuously), which also fails ``check_all_to_all``; the
  plan broadcast on the 1-D 8-rank mesh fails the two-level predicate.
* The report's single-device side (supersteps and ``msgs_*`` totals) of
  the hashmin, sssp and sv cells equals the JAX package's single-device
  ``Engine`` run on the same graph (n=180, M=8), exactly.
* The collective recorder logs op, group size and operand sizes only
  inside ``during``.

Its own file, so that one xdist worker takes its spawns.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro import api as rapi  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph import structs as rstructs  # noqa: E402
from repro.launch import shard_check as rsc  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import shard_check as sc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GATES = ("all_to_all", "routed_memory", "masked_lanes_ok", "hier_levels",
         "hier_caps_ok", "gspmm_hier", "gspmm_hier_f1")
CONTROLS = ("routed_memory", "routed_memory_silent", "all_to_all",
            "hier_levels")


@pytest.mark.parametrize("spec", ["1", "8", "2x4", "4x2"])
def test_parse_devices_equals_the_reference(spec):
    assert sc._parse_devices(spec) == rsc._parse_devices(spec)
    d = sc._parse_devices(spec)
    assert sc._dev_tag(d) == rsc._dev_tag(d) == spec
    assert sc._flat_devices(d) == rsc._flat_devices(d)


@pytest.mark.parametrize("suite", ["tier1", "hier", "full"])
def test_suite_cells_equal_the_reference(suite):
    assert sc._suite_cells(suite) == rsc._suite_cells(suite)
    assert sc.ALGOS == rsc.ALGOS


@pytest.fixture(scope="module")
def tier1(tmp_path_factory):
    out = tmp_path_factory.mktemp("shard_check") / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.shard_check", "--suite",
         "tier1", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    report = json.loads(out.read_text()) if out.exists() else None
    return proc, report


def test_tier1_suite_exits_0_with_every_cell_ok(tier1):
    proc, report = tier1
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "[shard_check] ALL CELLS OK" in proc.stdout
    assert report["ok"] is True
    assert all(errs == [] for errs in report["cells"].values())
    # every cell of the suite ran: one a (algo, layout, backend, devices)
    want = set()
    for algos, layouts, backends, devs, bal, pipe in sc._suite_cells(
            "tier1"):
        for a in algos:
            for lay in layouts:
                for be in backends:
                    for d in devs:
                        want.add(f"{a}/{lay}/{be}/{bal}/devices="
                                 f"{sc._dev_tag(d)}"
                                 + ("/pipeline" if pipe else ""))
    assert set(report["cells"]) == want
    assert sorted(report["worlds"]) == ["2", "8"]
    assert all(w["backend"] == "gloo" for w in report["worlds"].values())


@pytest.mark.parametrize("gate", GATES)
def test_every_gate_holds(tier1, gate):
    _, report = tier1
    got = report[gate]
    assert (got["ok"] if isinstance(got, dict) else got) is True
    if isinstance(got, dict) and "programs" in got:
        for name, entry in got["programs"].items():
            assert entry["calls"] > 0, name
            assert max(entry["collective_max_elems"]["all_reduce"],
                       entry["collective_max_elems"]["all_gather"]) < \
                got["n_pad"], name
            assert "peak_bytes" not in entry      # none on the CPU
            if "hier" in got:
                assert {2, 4} <= set(entry["all_to_all_group_sizes"]), name


@pytest.mark.parametrize("control", CONTROLS)
def test_every_gate_rejects_its_control(tier1, control):
    _, report = tier1
    assert report["controls"][control] is False


@pytest.mark.parametrize("algo,backend", [("hashmin", "pallas"),
                                          ("sssp", "pallas"),
                                          ("sv", "pallas"), ("sv", "dense")])
def test_single_device_side_equals_the_jax_engine(tier1, algo, backend):
    _, report = tier1
    got = report["reference"][f"{algo}/csr/{backend}/hash"]
    g = rgen.powerlaw(180, avg_deg=5, seed=1, weighted=True).symmetrized()
    pg = rstructs.partition(g, 8, tau=8, seed=0, layout="csr",
                            balance="hash", split_factor=1.1)
    params = {"sssp": dict(source=int(pg.perm[0]))}.get(algo, {})
    res = rapi.Engine(rapi.config_of(pg, backend=backend)).run(algo, pg,
                                                                **params)
    assert got["supersteps"] == int(res.n_supersteps)
    want = {k: int(np.asarray(v)) for k, v in res.stats.items()
            if k.startswith("msgs_")}
    assert got["msgs"] == want and want


@pytest.fixture
def group():
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(),
                                world_size=1, rank=0)
    yield
    if own:
        meshlib.destroy()


def test_recorder_logs_only_inside_during(group):
    x = torch.arange(6, dtype=torch.float32)
    with sc.record_collectives() as log:
        dist.all_reduce(x)                        # outside: not logged
        log.during(lambda: (dist.all_reduce(x),
                            dist.all_gather([torch.empty(6)], x)))()
        calls = list(log.calls)
    assert dist.all_reduce is not None and calls == [
        ("all_reduce", 1, [6]), ("all_gather", 1, [6, 6])]
    summary = sc.collective_summary(calls)
    assert summary["calls"] == 2 and sc.replicated_elems(summary) == 6
    assert sc.routed_ok(summary, 7) and not sc.routed_ok(summary, 6)
    assert not sc.routed_ok(sc.collective_summary([]), 7)
