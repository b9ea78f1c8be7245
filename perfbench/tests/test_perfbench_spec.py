"""BENCHMARK.json against the contract's shape, and a configuration, a
traffic mix, a cell and a metric added as files of their own being found."""
import json
import re

import pytest

from conftest import REPO
from perfbench.harness import cell as cell_mod
from perfbench.harness import main as main_mod
from perfbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in BENCH[k]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(x) for x in group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and m["layer"]
            assert "workloads" in m
    if kind == "end_to_end":
        assert "setup_s" in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.load_cell(cell, REPO)
    assert c.generator().generate and c.reference().compare
    assert c.traffic["loop"] == "closed" and c.limits
    kinds = {m.kind for m in c.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    assert "setup_s" in {m.name for m in c.metrics}


def test_unknown_cell_is_refused(tiny_root):
    with pytest.raises(KeyError):
        spec.load_cell("nope.nothing", tiny_root)


def test_added_files_are_found_and_reported(tiny_root):
    """A new configuration, traffic mix, cell and metric, each one file
    plus its line in BENCHMARK.json, reach the result line unedited."""
    bench = tiny_root / "perfbench"
    cfg = json.loads((bench / "configs" / "road.json").read_text())
    cfg["graph"].update(n=9001, arcs=21960, width=95)
    (bench / "configs" / "grid.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "hashmin.once.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "algo": "hashmin", "params": {}}))
    (bench / "workloads" / "grid.hashmin.json").write_text(json.dumps(
        {"limits": {"wrong_vertices": 0}}))
    (bench / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    spec_json = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec_json["configs"].append(dict(spec_json["configs"][1], name="grid",
                                     file="perfbench/configs/grid.json"))
    spec_json["workloads"].append({"name": "grid.hashmin", "config": "grid",
                                   "traffic": "hashmin.once", "chips": 1,
                                   "why": "a test cell"})
    spec_json["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                                   "better": "higher", "source": "host_clock",
                                   "layer": "BSP loop", "moves": "evps",
                                   "workloads": ["grid.hashmin"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    c = spec.load_cell("grid.hashmin", tiny_root)
    run = cell_mod.run_cell(c, 2**31 + 3, 0.5, True, "cpu")
    out = main_mod.result_of(run, True)
    assert out["correct"] is True
    assert out["metrics"]["jobs_done"]["value"] == len(run.jobs) >= 1
    assert run.n == 9001 and run.arcs == 21960
    assert "combine.roofline" not in out["metrics"]     # no device here
