"""Port parity: the graph service's repartition and overflow programs
over ``torch.distributed`` (gloo, CPU processes) at world sizes 1, 2 and
4, on spawns of their own (``test_torch_service_sharded.spawn_service``:
``_torch_service_worker`` with a spec of scenarios alone).

Each rank runs the world-size-1 cases of ``test_torch_service.py`` on a
service of its own: the elastic repartition (``rebalance_threshold=1.0``,
then a 5% churn fold) and the profile overflow (``profile_slack=1.01``,
then a fold that doubles the edge count).  Each rank decides the
repartition from the all-reduced per-worker statistics and the overflow
from the whole partition's tables, so every rank must end with world size
1's answers, repartition count, partition and ``traces`` (+2 after the
overflow), and with the profile that ``shard_profile`` gives for that
partition at D (its caps are per device, so they differ between world
sizes).  Also the launcher, ``serve_graph --devices 2``, on two ranks.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import generators as rgen  # noqa: E402
from repro.graph import structs as rstructs  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from test_service import churn_delta  # noqa: E402
from test_torch_service_sharded import (SERVICE, WORLDS,  # noqa: E402,F401
                                        assert_same_answers,
                                        assert_same_batch, delta_spec,
                                        graph, graph_spec, spawn_service)

ROOT = Path(__file__).resolve().parents[1]
OVERFLOW_SLACK = 1.01


def doubling_delta(g, seed=9):
    """As many new random edges as ``g`` has (both directions): a fold
    that must outgrow any profile of slack < 2."""
    rng = np.random.RandomState(seed)
    a_s = rng.randint(0, g.n, size=g.m)
    a_d = rng.randint(1, g.n, size=g.m)
    keep = a_s != a_d
    return rstructs.EdgeDelta(
        add_src=a_s[keep], add_dst=a_d[keep],
        add_w=rng.rand(int(keep.sum())).astype(np.float32) + 0.01
    ).symmetrized()


def scenarios(graph) -> dict:
    """The world-size-1 repartition and overflow cases of
    ``test_torch_service.py`` on M=8 workers."""
    small = rgen.powerlaw(200, avg_deg=4, seed=5, weighted=True
                          ).symmetrized()
    return {
        "repartition": dict(
            graph_spec(graph), delta=delta_spec(churn_delta(graph, 0.05,
                                                            21)),
            service=dict(SERVICE, buckets=(2,), ppr_iters=6,
                         rebalance_threshold=1.0),
            first=[("sssp", 0), ("ppr", 7)],
            second=[("sssp", 12), ("ppr", 29), ("ego", 4)]),
        "overflow": dict(
            graph_spec(small), delta=delta_spec(doubling_delta(small)),
            service=dict(SERVICE, buckets=(2,), ppr_iters=6,
                         profile_slack=OVERFLOW_SLACK),
            first=[], second=[("sssp", 3), ("ppr", 8), ("ego", 3)])}


@pytest.fixture(scope="module")
def runs(graph, tmp_path_factory):  # noqa: F811
    """{D: [rank 0's record, rank 1's, ...]}: the scenarios alone."""
    return spawn_service({"scenarios": scenarios(graph)}, tmp_path_factory,
                         "scenarios")


def assert_same_partition(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        if isinstance(v, np.ndarray) or isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("D", [2, 4])
def test_elastic_repartition_at_D_equals_world_size_1(runs, D):
    want = runs[1][0]["scenarios"]["repartition"]
    assert want["first_repartitions"] >= 1
    for r in runs[D]:
        got = r["scenarios"]["repartition"]
        for key in ("first", "second"):
            assert_same_answers(want[key], got[key])
        assert got["first_repartitions"] == want["first_repartitions"]
        assert got["repartitions"] == want["repartitions"]
        # the repartition reshards under the frozen profile: no rebuild
        assert got["traces"] == got["warm_traces"] == want["traces"]
        assert_same_partition(want["pg"], got["pg"])
        assert_same_batch(want["batch"], got["batch"])


@pytest.mark.parametrize("D", [2, 4])
def test_profile_overflow_at_D_equals_world_size_1(runs, D):
    want = runs[1][0]["scenarios"]["overflow"]
    for r in runs[D]:
        got = r["scenarios"]["overflow"]
        assert_same_answers(want["second"], got["second"])
        assert all(e == 1 for _, _, e, _, _ in got["second"])
        # the bucket's executor and the component program are built again
        assert got["traces"] == got["warm_traces"] + 2 == want["traces"]
        assert_same_partition(want["pg"], got["pg"])
        assert_same_batch(want["batch"], got["batch"])


@pytest.mark.parametrize("D", WORLDS)
def test_overflow_refreezes_the_same_profile_on_every_rank(runs, D):
    """Every rank froze the profile of the folded partition at D (the
    test process recomputes it from the tables alone)."""
    fresh = dataclasses.asdict(texec.shard_profile(
        tstructs.from_numpy(runs[1][0]["scenarios"]["overflow"]["pg"],
                            device="cpu"), D, slack=OVERFLOW_SLACK))
    for r in runs[D]:
        got = r["scenarios"]["overflow"]
        assert got["profile0"] == runs[D][0]["scenarios"]["overflow"][
            "profile0"]
        assert got["profile"] != got["profile0"]
        assert got["profile"] == fresh


def test_serve_graph_cli_on_two_ranks():
    """``serve_graph --devices 2`` spawns two gloo ranks; rank 0 prints
    the reference's lines, and the launcher's checks pass."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_graph", "--device",
         "cpu", "--devices", "2", "--n", "2000", "--workers", "4",
         "--batch", "12", "--buckets", "2", "4"], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert out.count("[serve-graph] resident graph n=2000") == 1
    for tag in ("devices=2", "(epoch 1, no executor built)",
                "post-fold parity vs fresh partition() OK",
                "[serve-graph] OK"):
        assert tag in out, (tag, out)
