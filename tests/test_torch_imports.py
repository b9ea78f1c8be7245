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
from repro_torch.core import service as tservice  # noqa: E402
from repro_torch.launch import graph_run, serve_graph, serve_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "tests").glob("_torch_*worker.py")) + sorted(
            (ROOT / "tools").glob("*.py")) + sorted(
                (ROOT / "examples" / "torch").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")
# the launchers, fault tolerance, the MoE layer, LM training and its mesh:
# each a module of its own that must stay free of JAX, also when imported
# alone
STANDALONE = ("repro_torch.launch.shard_check",
              "repro_torch.launch.dist_smoke",
              "repro_torch.train.checkpoint", "repro_torch.train.fault",
              "repro_torch.models.moe", "repro_torch.train.data",
              "repro_torch.train.train_step", "repro_torch.launch.train",
              "repro_torch.launch.shardings", "repro_torch.launch.mesh",
              "repro_torch.models.collectives",
              "repro_torch.models.embedding",
              # tensor parallelism and serving on the mesh, and the ranks
              # of their tests (tests/_torch_*worker.py)
              "repro_torch.models.layers", "repro_torch.models.ssm",
              "repro_torch.models.transformer",
              "repro_torch.models.model_zoo",
              "_torch_serve_mesh_worker", "_torch_train_mesh_worker",
              # the dry run of the production mesh and its ranks
              "repro_torch.launch.roofline", "repro_torch.launch.comm_stats",
              "repro_torch.launch.dryrun", "_torch_dryrun_worker")


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


@pytest.mark.parametrize("module", STANDALONE)
def test_launchers_and_fault_tolerance_import_no_jax(module):
    home = ROOT / "tests" if module.startswith("_torch_") else ROOT / "src"
    path = home / (module.replace(".", "/") + ".py")
    assert path in PORT_FILES
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(home)]))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_importing_the_dry_run_initialises_no_cuda():
    """The dry run runs on no device: importing it (and its models and
    step factories) leaves CUDA uninitialised."""
    code = ("import torch, repro_torch.launch.dryrun\n"
            "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.parametrize("example", ["quickstart", "graph_analytics",
                                     "serve_lm", "train_lm"])
def test_examples_default_to_cuda_and_raise_without_it(no_cuda, example):
    """The port's examples ask for the card unless ``--device cpu``."""
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{example}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{example}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.main(["10"] if example in ("quickstart", "graph_analytics",
                                       "train_lm") else [])


def test_launchers_refuse_cuda_without_a_card(no_cuda):
    from repro_torch.launch import dist_smoke, shard_check
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_check.main(["--suite", "tier1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_smoke.main(["--device", "cuda"])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device is usable where CUDA is")
@pytest.mark.parametrize("module", ["shard_check", "dist_smoke"])
def test_launchers_default_to_cuda_and_raise_without_a_card(module):
    """No ``--device``: the launcher asks for the card and raises on a
    machine without one, never running on the CPU unasked."""
    from repro_torch.launch import dist_smoke, shard_check
    launcher = {"shard_check": shard_check, "dist_smoke": dist_smoke}[module]
    assert launcher.build_parser().parse_args([]).device == "cuda"
    argv = ["--suite", "tier1"] if module == "shard_check" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(argv)


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


def test_graph_run_gcn_cpu_prints_the_reference_lines(capsys):
    graph_run.main(["--algo", "gcn", "--n", "400", "--workers", "4",
                    "--backend", "pallas", "--layout", "csr",
                    "--feat-dim", "8", "--hidden", "16", "--classes", "4",
                    "--epochs", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    for tag in ("[graph] powerlaw", "[gcn] F=8 hidden=16 classes=4: loss",
                "[run] gcn: 3 supersteps", "msgs_total", "msgs_mirror",
                "balance[per_worker_total]"):
        assert tag in out


def test_gcn_entry_point_defaults_to_cuda_and_raises_without_it(no_cuda):
    g = tgen.powerlaw(60, seed=0).symmetrized()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.Engine(backend="pallas", layout="csr").run("gcn", g, M=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        graph_run.main(["--algo", "gcn", "--n", "60", "--workers", "2"])
    res = tapi.Engine(backend="pallas", layout="csr", device="cpu").run(
        "gcn", g, M=2, epochs=1, feat_dim=4, hidden=8, n_classes=2)
    assert res.state["emb"].device.type == "cpu"


def test_serve_model_defaults_to_cuda_and_raises_without_it(no_cuda, capsys):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_model.run("hymba_1_5b", True, 2, 8, 2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_model.main(["--arch", "hymba_1_5b", "--batch", "2",
                          "--prompt-len", "8", "--gen", "2"])
    serve_model.main(["--arch", "hymba_1_5b", "--batch", "2",
                      "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
    assert "[serve] hymba_1_5b: batch=2 prompt=8 gen=2" in (
        capsys.readouterr().out)


def test_serve_graph_defaults_to_cuda_and_raises_without_it(no_cuda):
    g = tgen.powerlaw(60, seed=0).symmetrized()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tservice.GraphService(g, M=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_graph.main(["--n", "60", "--workers", "2"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_graph.main(["--n", "60", "--workers", "2", "--devices", "2"])
    args = serve_graph.build_parser().parse_args([])
    assert (args.device, args.devices, args.n, args.workers, args.batch,
            args.buckets, args.churn, args.ppr_iters) == (
                "cuda", 1, 200_000, 32, 64, [4, 16, 64], 0.01, 20)


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
