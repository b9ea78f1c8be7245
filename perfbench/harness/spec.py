"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

Every piece of a cell lives in a file of its own under ``perfbench/``, so a
later change adds a configuration, a traffic mix, a cell or a metric by
adding files and never edits one:

* configuration   ``configs/<config>.json``   the deployment: graph and engine
* graph generator ``graphs/<generator>.py``   named by the configuration
* traffic mix     ``traffic/<traffic>.json``  the job stream: algorithm, params
* cell            ``workloads/<cell>.json``   the limits of its check
* metric reader   ``metrics/<metric>.py``     ``read(run) -> float | None``
* reference       ``reference/<algo>.py``     ``expected`` and ``compare``
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_modules: Dict[Path, ModuleType] = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import a reader or generator from its file.  Names may hold dots
    (``combine.roofline``), so the file is loaded by path, once."""
    path = path.resolve()
    mod = _modules.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no such benchmark file: {path}")
        tag = re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
        spec = importlib.util.spec_from_file_location(f"perfbench_{tag}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str                    # "end_to_end" | "per_layer"

    def reader(self, bench: Path) -> ModuleType:
        return load_module(bench / "metrics" / f"{self.name}.py")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: List[Metric]
    bench: Path

    def generator(self) -> ModuleType:
        gen = self.config["graph"]["generator"]
        return load_module(self.bench / "graphs" / f"{gen}.py")

    def reference(self) -> ModuleType:
        return load_module(self.bench / "reference"
                           / f"{self.traffic['algo']}.py")

    def metrics_of(self, kind: str) -> List[Metric]:
        return [m for m in self.metrics if m.kind == kind]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and the files it
    names; raises KeyError for a cell the file does not list."""
    root = Path(root)
    bench = root / "perfbench"
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    config = load_json(bench / "configs" / f"{w['config']}.json")
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    own = load_json(bench / "workloads" / f"{name}.json")
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"{w['traffic']}: the harness drives a closed loop "
                         "of one client")
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            only = m.get("workloads")
            if only is not None and name not in only:
                continue
            metrics.append(Metric(m["name"], m["unit"], kind))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=dict(own["limits"]), metrics=metrics,
                bench=bench)
