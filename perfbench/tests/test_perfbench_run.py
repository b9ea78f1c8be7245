"""One run on the CPU at a tiny size: the result line's keys, the check
failing on a broken timed path, and the control reading above the limit."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import REPO
from perfbench import control
from perfbench.harness import cell as cell_mod
from perfbench.harness import main as main_mod
from perfbench.harness import spec

SEED = 2**31 + 77
CELLS = ["lj.hashmin", "road.sv"]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tiny_root, trace):
    c = spec.load_cell("road.sv", tiny_root)
    run = cell_mod.run_cell(c, SEED, 0.3, trace, "cpu")
    out = main_mod.result_of(run, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys and list(out)[-1] == "check"
    assert out["correct"] is True and out["attempted"] == len(run.jobs) >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    named = {m.name for m in c.metrics_of(kind)}
    assert set(out["metrics"]) <= named
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"partition_s", "warmup_s", "superstep_ms",
                "msg_ratio"} <= set(out["metrics"])
    else:
        assert {"evps", "setup_s"} <= set(out["metrics"])
    assert out["check"] == {"wrong_vertices": {"value": 0, "limit": 0}}
    json.dumps(out)


def _unchanged(engine):
    def run(algo, pg, **kw):
        res = engine.run(algo, pg, **kw)
        res.state = pg.local_ids().to(torch.int32)
        return res
    return run


def _altered(engine):
    def run(algo, pg, **kw):
        res = engine.run(algo, pg, **kw)
        flat = res.state.reshape(-1)
        real = flat[pg.vmask.reshape(-1)]
        common = torch.mode(real).values
        at = torch.nonzero((flat == common) & pg.vmask.reshape(-1))[0]
        flat[at] = flat[at] + 1
        return res
    return run


def _half_left_out(engine):
    def run(algo, pg, **kw):
        res = engine.run(algo, pg, **kw)
        half = pg.M // 2
        res.state[half:] = pg.local_ids()[half:].to(res.state.dtype)
        return res
    return run


FAULTS = {"state unchanged": _unchanged, "an answer altered": _altered,
          "half the workers left out": _half_left_out}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, name,
                                          fault):
    """The harness with its look for a chip skipped and the timed path
    broken underneath: ``correct`` comes out false."""
    real_load = cell_mod.load
    made = {}

    def load(*a, **k):
        ld = real_load(*a, **k)
        made["run"] = FAULTS[fault](ld.engine)
        return ld
    monkeypatch.setattr(cell_mod, "load", load)

    def broken(algo, pg, **kw):
        return made["run"](algo, pg, **kw)
    c = spec.load_cell(name, tiny_root)
    run = cell_mod.run_cell(c, SEED, 0.2, False, "cpu", algo_run=broken)
    assert run.check["wrong_vertices"] > 0
    assert main_mod.result_of(run, False)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_limit(tiny_root, name):
    """The control (the program stopped before its last changing
    superstep) fails the limit on three seeds; the sound job meets it."""
    c = spec.load_cell(name, tiny_root)
    for seed in (SEED, 1, 2):
        r = control.readings(c, seed, "cpu")
        assert r["sound"]["wrong_vertices"] <= c.limits["wrong_vertices"]
        assert r["control"]["wrong_vertices"] > c.limits["wrong_vertices"]


def test_cli_needs_the_program_and_a_card(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/, and here
    without a card, the command exits non-zero and prints no result."""
    import shutil
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    args = ["--workload", "road.sv", "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    for root in (tmp_path, REPO):
        p = subprocess.run([sys.executable, "perfbench/run.py", *args],
                           cwd=root, capture_output=True, text=True,
                           timeout=120)
        if root == REPO and torch.cuda.is_available():
            continue
        assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    """A short run of each cell at its full size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        name, "--seed", "7", "--seconds", "2", "--trace",
                        "0"], cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
