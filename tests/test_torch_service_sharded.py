"""Port parity: the graph service over ``torch.distributed`` (gloo, CPU
processes) against world size 1 and the JAX package's service.

Each world size D in {1, 2, 4} is one spawn of D ranks
(``_torch_service_worker``), each holding a ``GraphService`` on the same
graph and running the same client program; at every ``pump()`` rank 0's
queue and deltas are broadcast, so every rank folds and serves the same
batch.  Contract: every rank returns rank 0's answers; at D = 2 and 4 the
answers, epochs, ``cached`` flags, supersteps and ``msgs_*`` statistics
equal world size 1's (SSSP and ego bitwise, PPR within 1e-6 of its max:
the dense sum combines each rank's partial sums in another order); world
size 1 equals the reference service on the same queries; the executor
counter stays flat across the batch and the fold and the tables keep
their storage on every rank.

The service's repartition and overflow programs at D ranks, and the
launcher on two ranks, are in ``test_torch_service_scenarios.py``, with
spawns of their own (``spawn_service``, shared with it).

Its own file, so that an xdist worker takes these spawns alone.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_service_worker as worker  # noqa: E402
from repro.api import EngineConfig as REngineConfig  # noqa: E402
from repro.core import service as rservice  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402
from test_service import churn_delta  # noqa: E402

SPAWN_TIMEOUT_S = 300
WORLDS = (1, 2, 4)
PPR_RTOL = 1e-6
SERVICE = dict(M=8, buckets=(2, 4), ppr_iters=8, max_supersteps=64,
               profile_slack=2.0)
BATCH = [("sssp", 0), ("sssp", 11), ("ppr", 7), ("ego", 5), ("ppr", 7),
         ("sssp", 0), ("ego", 200), ("ppr", 150), ("sssp", 299)]
PROBE = [("sssp", 17), ("ppr", 23), ("ego", 5)]


def graph_spec(g) -> dict:
    return {"n": g.n, "src": g.src, "dst": g.dst, "w": g.weight}


def delta_spec(d) -> dict:
    return {k: getattr(d, k) for k in ("add_src", "add_dst", "add_w",
                                       "rem_src", "rem_dst")}


@pytest.fixture(scope="module")
def graph():
    return rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()


@pytest.fixture(scope="module")
def delta(graph):
    return churn_delta(graph, 0.05, 42)


def spawn_service(spec: dict, tmp_path_factory, tag: str) -> dict:
    """{D: [rank 0's record, rank 1's, ...]}: one spawn of
    ``_torch_service_worker`` a world size on ``spec``."""
    out = {}
    for D in WORLDS:
        tmp = tmp_path_factory.mktemp(f"{tag}{D}")
        with open(tmp / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        spawn_ranks(worker.rank_main,
                    (D, str(tmp / "store"), str(tmp / "spec.pkl"),
                     str(tmp / "out")), D, SPAWN_TIMEOUT_S)
        out[D] = []
        for r in range(D):
            with open(tmp / f"out.{r}", "rb") as f:
                out[D].append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(graph, delta, tmp_path_factory):
    """{D: [rank 0's record, rank 1's, ...]}: the client program."""
    return spawn_service(dict(graph_spec(graph), service=SERVICE,
                              batch=BATCH, probe=PROBE,
                              delta=delta_spec(delta)),
                         tmp_path_factory, "service")


def assert_same_answers(want, got, ppr_rtol=PPR_RTOL):
    assert len(want) == len(got)
    for (k, s, e, c, v), (k2, s2, e2, c2, v2) in zip(want, got):
        assert (k, s, e, c) == (k2, s2, e2, c2)
        if k == "ppr":
            scale = max(float(np.abs(v).max()), 1e-30)
            assert float(np.abs(np.asarray(v2) - v).max()) <= ppr_rtol * scale
        elif k == "sssp":
            np.testing.assert_array_equal(v2, v)
        else:
            assert v2 == v


def assert_same_batch(want, got):
    a, b = want["last_batch"], got["last_batch"]
    for k in ("bucket", "epoch", "lanes_sssp", "lanes_ppr", "n_supersteps"):
        assert a[k] == b[k], k
    assert sorted(a["stats"]) == sorted(b["stats"])
    for k, v in a["stats"].items():
        np.testing.assert_array_equal(np.asarray(b["stats"][k]),
                                      np.asarray(v), err_msg=k)
    assert want["last_pump"] == got["last_pump"]
    assert want["epoch"] == got["epoch"]


@pytest.mark.parametrize("D", WORLDS)
def test_every_rank_returns_rank_0s_answers(runs, D):
    ranks = runs[D]
    assert [r["rank"] for r in ranks] == list(range(D))
    assert all(r["world"] == D for r in ranks)
    for r in ranks[1:]:
        for key in ("pre", "post", "rank0_queue"):
            assert_same_answers(ranks[0][key], r[key], ppr_rtol=0.0)
        np.testing.assert_array_equal(r["labels"], ranks[0]["labels"])


@pytest.mark.parametrize("D", WORLDS)
def test_rank_0s_queue_is_served_everywhere(runs, D):
    got = runs[D][0]["rank0_queue"]
    assert [(k, s) for k, s, _, _, _ in got] == PROBE
    # the probe was answered after the fold (epoch 1) and is cached
    assert all(e == 1 and c for _, _, e, c, _ in got)


@pytest.mark.parametrize("D", [2, 4])
def test_answers_equal_world_size_1(runs, D):
    for key in ("pre", "post", "rank0_queue"):
        assert_same_answers(runs[1][0][key], runs[D][0][key])


@pytest.mark.parametrize("D", [2, 4])
def test_stats_and_supersteps_equal_world_size_1(runs, D):
    for key in ("pre_batch", "post_batch"):
        assert_same_batch(runs[1][0][key], runs[D][0][key])


@pytest.mark.parametrize("D", WORLDS)
def test_counter_flat_and_storage_kept_on_every_rank(runs, D):
    for r in runs[D]:
        assert r["warm_traces"] == len(SERVICE["buckets"]) + 1
        assert r["pre_batch"]["traces"] == r["post_batch"]["traces"] == (
            r["warm_traces"])
        assert r["storage_kept"]
        assert r["post_batch"]["epoch"] == 1
        assert all(e == 1 for _, _, e, _, _ in r["post"])


def test_world_size_1_equals_the_reference(runs, graph, delta):
    ref = rservice.GraphService(
        graph, config=REngineConfig(layout="csr", balance="edges",
                                    devices=1), **SERVICE)
    ref.warmup()
    client = rservice.GraphClient(ref)
    want = {"pre": client.request([rservice.Query(k, s) for k, s in BATCH])}
    pre_batch = {"last_batch": dict(ref.last_batch),
                 "last_pump": dict(ref.last_pump), "epoch": ref.epoch}
    ref.mutate(delta)
    want["post"] = client.request([rservice.Query(k, s)
                                   for k, s in PROBE + BATCH])
    post_batch = {"last_batch": dict(ref.last_batch),
                  "last_pump": dict(ref.last_pump), "epoch": ref.epoch}
    got = runs[1][0]
    for key in ("pre", "post"):
        assert_same_answers(worker.answers(want[key]), got[key])
    assert_same_batch(pre_batch, got["pre_batch"])
    assert_same_batch(post_batch, got["post_batch"])
