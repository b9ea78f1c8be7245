"""No module that the harness or the reference loads has the top-level
name of JAX or of the JAX package (compared whole: the port's name begins
with the package's), and the reference loads nothing of the port."""
import ast
import json
import subprocess
import sys

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PRELUDE = f"""
import sys, json
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
"""


def tops_after(code: str) -> set:
    script = PRELUDE + code + """
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    tops = tops_after(f"""
sys.path.insert(0, {str(REPO / 'perfbench' / 'tests')!r})
from pathlib import Path
from conftest import make_root
from perfbench.harness import spec, cell, main
from perfbench import control
root = make_root(Path({str(tmp_path)!r}))
for name in ("lj.hashmin", "road.sv"):
    c = spec.load_cell(name, root)
    for trace in (False, True):
        run = cell.run_cell(c, 3, 0.2, trace, "cpu")
        main.result_of(run, trace)
    control.readings(c, 4, "cpu")
assert not main.forbidden_modules()
""")
    assert not tops & FORBIDDEN
    assert "repro_torch" in tops          # the program itself was run


def test_the_reference_loads_nothing_of_the_program():
    tops = tops_after("""
from pathlib import Path
from perfbench.harness.spec import load_module, BENCH
for d in ("reference", "graphs"):
    for f in sorted((BENCH / d).glob("*.py")):
        load_module(f)
""")
    assert not tops & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "perfbench").rglob("*.py") if "tests" not in p.parts))
def test_sources_import_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    if "/reference/" in path or "/graphs/" in path:
        assert names <= {"__future__", "torch", "numpy", "math", "perfbench"}
