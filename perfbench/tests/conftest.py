"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark at
a tiny size, run on the CPU through the harness's own functions."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the graphs of the tiny copy: the shapes of the real configurations at
#: about 20 thousand vertices
TINY = {"lj": {"n": 20000, "undirected_edges": 176700,
               "exponent_of": {"n": 20000, "undirected_edges": 176700,
                               "max_expected_degree": 400}},
        "road": {"n": 20011, "arcs": 48816, "width": 141}}


def make_root(dst: Path, graphs=TINY) -> Path:
    """A checkout holding ``BENCHMARK.json``, ``perfbench/`` and a link to
    the program's ``src/``, with the configurations cut to ``graphs``."""
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (dst / "src").symlink_to(REPO / "src")
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, upd in graphs.items():
        p = dst / "perfbench" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg["graph"].update(upd)
        p.write_text(json.dumps(cfg))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
