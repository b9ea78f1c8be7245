"""Port: ``python -m repro_torch.launch.dist_smoke`` on the CPU.

Two launcher processes (hosts), each starting two rank processes (gloo),
run one sharded Hash-Min on the (2, 2) mesh and compare it with each
rank's single-device run, once over ``--init-method`` with a file store
(``graph_run.rendezvous``) and once over the launchers' own TCP store on
a port the first launcher binds (``--port 0``).  Contract: exit 0, four
``parity OK`` lines, enumeration lines with world size 4 and two ranks a
host, and every launcher's ranks exiting 0.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.launch.graph_run import rendezvous  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=["file", "tcp"])
def run(request, tmp_path_factory):
    extra = (["--init-method", rendezvous(str(tmp_path_factory.mktemp(
        "store")))] if request.param == "file" else ["--port", "0"])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_smoke", "--hosts",
         "2", "--per-host", "2", "--device", "cpu", *extra], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    return request.param, proc


def test_exits_0(run):
    _, proc = run
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "[dist_smoke] launcher exit codes: [0, 0]" in proc.stdout


def test_four_ranks_hold_parity(run):
    _, proc = run
    ok = re.findall(r"^\[dist_smoke\] rank (\d): hashmin .*: parity OK$",
                    proc.stdout, re.M)
    assert sorted(ok) == ["0", "1", "2", "3"], proc.stdout
    assert "VIOLATED" not in proc.stdout


def test_enumeration_world_4_two_ranks_a_host(run):
    _, proc = run
    lines = re.findall(r"^\[dist_smoke\] rank (\d): world size (\d+), host "
                       r"(\d) ranks \[(\d), (\d)\], gloo on cpu",
                       proc.stdout, re.M)
    assert len(lines) == 4, proc.stdout
    for rank, world, host, a, b in lines:
        assert world == "4"
        assert int(rank) // 2 == int(host)
        assert (int(a), int(b)) == (2 * int(host), 2 * int(host) + 1)
    codes = re.findall(r"^\[dist_smoke\] host (\d): rank exit codes \[0, 0\]$",
                       proc.stdout, re.M)
    assert sorted(codes) == ["0", "1"]


def test_rendezvous_is_the_one_asked_for(run):
    mode, proc = run
    if mode == "file":
        assert "over file://" in proc.stdout
    else:
        port = re.search(r"over tcp store 127\.0\.0\.1:(\d+);", proc.stdout)
        assert port and int(port.group(1)) > 0
