"""Rules of the port: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor the JAX package, and the entry points run on the GPU unless the
caller asks for the CPU (without CUDA they raise, never fall back)."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api as tapi  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from repro_torch.launch import graph_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    g = tgen.powerlaw(60, seed=0).symmetrized()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.Engine()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.Engine(tapi.EngineConfig(backend="pallas"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tstructs.partition(g, 2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        graph_run.main(["--n", "60", "--workers", "2"])
    # the explicit CPU request works
    pg = tstructs.partition(g, 2, device="cpu")
    assert pg.device.type == "cpu"
    assert tapi.Engine(device="cpu").run("hashmin", pg).n_supersteps > 0


def test_graph_run_cpu_prints_the_reference_lines(capsys):
    graph_run.main(["--algo", "sssp", "--n", "400", "--workers", "4",
                    "--backend", "pallas", "--layout", "csr",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    for tag in ("[graph] powerlaw", "[balance] hash", "[run] sssp",
                "msgs_total", "balance[per_worker_total]"):
        assert tag in out


def _run_chip_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, even if one exists
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
