"""The resident graph service's launcher on the CPU:
``python -m repro_torch.launch.serve_graph`` at world size 1 in a process
of its own prints the reference launcher's ``[serve-graph]`` lines and
makes its checks.  (The service's parity tests against the JAX package are
in ``test_torch_service.py``; this case has a file of its own because it
takes as long as all of them under the suite's one-file-a-worker
scheduling.)
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_serve_graph_cli_on_the_cpu():
    """The launcher at world size 1 in its own process: the reference's
    [serve-graph] lines and its checks (flat counter, epoch 1, post-fold
    parity with a fresh partition)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_graph", "--device",
         "cpu", "--n", "2000", "--workers", "4", "--batch", "12",
         "--buckets", "2", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    for tag in ("[serve-graph] resident graph n=2000", "warmup: 3 executors",
                "12 mixed queries", "(epoch 1, no executor built)",
                "post-fold parity vs fresh partition() OK",
                "[serve-graph] OK"):
        assert tag in proc.stdout, (tag, proc.stdout)
