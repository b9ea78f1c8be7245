"""Port parity: the sharded executor over ``torch.distributed`` (gloo, CPU
processes) against one device.

Each world size D is one spawn of D ranks (``_torch_sharded_worker``) that
runs the whole matrix of that D: the six algorithms at D in {1, 2, 4} on
padded/csr x dense/pallas, the balance modes edges, edges+refine and
vertex-cut on csr/pallas at D = 2, Hash-Min at D = 8, and the routed
exchanges at a forced small cap at D in {2, 4}.  The partitions are the
reference's, carried into the port by ``same_partition``.

Contract: min, max and integer state bitwise, PageRank within rtol 1e-5,
MSF's total weight within 1e-6 of it; every ``msgs_*`` and
``per_worker_*`` equal integer for integer; the same supersteps.  The runs
are held to the port's single-device runs (which the other test files hold
to the reference), and Hash-Min, S-V, PageRank and MSF also to the
single-device reference directly.
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_sharded_worker as worker  # noqa: E402
from repro import api as rapi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import channels as tchannels  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402
from test_torch_graph import graph_pair, same_partition  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M = 8
SPAWN_TIMEOUT_S = 300
ALGOS = [("hashmin", {}), ("pagerank", {"n_iters": 12, "tol": 0.0}),
         ("sssp", {"source": "perm0"}), ("sv", {}), ("msf", {}),
         ("attr_bcast", {"attr": "ramp"})]
CONFIGS = [(lay, b) for lay in ("padded", "csr") for b in ("dense", "pallas")]
BALANCES = ("edges", "edges+refine", "vertex-cut")
PARTS = {"hash-padded": ("hash", "padded"), "hash-csr": ("hash", "csr")}
PARTS.update({f"{b}-csr": (b, "csr") for b in BALANCES})


def _jobs(D):
    jobs = {}
    if D in (1, 2, 4):
        for lay, b in CONFIGS:
            for algo, params in ALGOS:
                jobs[f"{lay}-{b}-{algo}"] = (
                    f"hash-{lay}", dict(backend=b, layout=lay), algo, params)
    if D == 2:
        for bal in BALANCES:
            for algo, params in ALGOS:
                jobs[f"{bal}-csr-pallas-{algo}"] = (
                    f"{bal}-csr", dict(backend="pallas", layout="csr",
                                       balance=bal), algo, params)
        jobs["history"] = ("hash-csr", dict(backend="pallas", layout="csr"),
                           "hashmin", {"record_history": True})
    if D == 8:
        for lay, b in (("csr", "pallas"), ("padded", "dense")):
            jobs[f"{lay}-{b}-hashmin"] = (
                f"hash-{lay}", dict(backend=b, layout=lay), "hashmin", {})
    return jobs


WORLD = {D: _jobs(D) for D in (1, 2, 4, 8)}
CASES = [(D, name) for D, jobs in WORLD.items() for name in jobs
         if name != "history"]
EXCHANGE_DS = (2, 4)


@pytest.fixture(scope="module")
def parts():
    g_ref, _ = graph_pair("powerlaw", 300, seed=5, weighted=True)
    return {name: same_partition(g_ref, M, tau=8, seed=1, layout=lay,
                                 balance=bal)
            for name, (bal, lay) in PARTS.items()}


@pytest.fixture(scope="module")
def sharded(parts, tmp_path_factory):
    """{D: [rank 0's results, rank 1's, ...]}: one spawn a world size."""
    out = {}
    for D, jobs in WORLD.items():
        tmp = tmp_path_factory.mktemp(f"world{D}")
        used = {part for part, _, _, _ in jobs.values()}
        spec = {"partitions": {k: tstructs.to_numpy(parts[k][1])
                               for k in used},
                "jobs": jobs,
                "exchange": "hash-csr" if D in EXCHANGE_DS else None}
        if spec["exchange"]:
            spec["partitions"]["hash-csr"] = tstructs.to_numpy(
                parts["hash-csr"][1])
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


_single_cache = {}


def single(parts, part, cfg, algo, params):
    """The port's single-device run of one job (cached)."""
    key = (part, tuple(sorted(cfg.items())), algo, repr(params))
    if key not in _single_cache:
        pg = parts[part][1]
        _single_cache[key] = tapi.Engine(device="cpu", **cfg).run(
            algo, pg, **worker.job_params(pg, params))
    return _single_cache[key]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_tree_equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_same_run(want, got, algo):
    """``got`` (a sharded run as the worker packs it) equals ``want`` (a
    single-device RunResult of either package) under the contract."""
    assert got["n"] == want.n_supersteps
    assert set(got["stats"]) == set(want.stats)
    for k, v in want.stats.items():
        np.testing.assert_array_equal(np.asarray(got["stats"][k]), _np(v),
                                      err_msg=k)
    if algo == "pagerank":
        np.testing.assert_allclose(got["state"], _np(want.state), rtol=1e-5,
                                   atol=0)
    elif algo == "msf":
        (la, wa, na), (lb, wb, nb) = got["state"], want.state
        np.testing.assert_array_equal(la, _np(lb))
        assert int(na) == int(nb)
        assert abs(float(wa) - float(wb)) <= 1e-6 * abs(float(wb))
    elif algo == "sssp" or algo == "attr_bcast":
        np.testing.assert_array_equal(got["state"], _np(want.state))
    else:
        got_s, want_s = got["state"], _np(want.state)
        assert got_s.dtype == want_s.dtype
        np.testing.assert_array_equal(got_s, want_s)


@pytest.mark.parametrize("D,name", CASES,
                         ids=[f"D{D}-{name}" for D, name in CASES])
def test_sharded_equals_one_device(parts, sharded, D, name):
    part, cfg, algo, params = WORLD[D][name]
    got = sharded[D][0][name]
    assert_same_run(single(parts, part, cfg, algo, params), got, algo)
    info = got["sharded"]
    # one host read a superstep (the halt vote; attr_bcast has no BSP
    # loop) and one a routed join (its round count)
    loop = 0 if algo == "attr_bcast" else got["n"]
    assert info["host_reads"] == loop + len(info["rounds"])
    assert info["table_bytes"] > 0 and info["build_s"] >= 0
    # every rank returns the same global result
    for r in range(1, D):
        other = sharded[D][r][name]
        assert other["n"] == got["n"]
        assert_tree_equal(other["state"], got["state"])


def test_sharded_history_is_summed_over_ranks(parts, sharded):
    part, cfg, algo, params = WORLD[2]["history"]
    got = sharded[2][0]["history"]
    want = single(parts, part, cfg, algo, params)
    assert set(got["history"]) == set(want.history)
    for k, v in want.history.items():
        np.testing.assert_array_equal(got["history"][k], _np(v), err_msg=k)


@pytest.mark.parametrize("algo,layout,backend", [
    ("hashmin", "csr", "pallas"), ("sv", "csr", "pallas"),
    ("pagerank", "csr", "pallas"), ("msf", "padded", "dense")])
def test_sharded_equals_the_reference(parts, sharded, algo, layout, backend):
    pg_ref, _ = parts[f"hash-{layout}"]
    params = dict(ALGOS)[algo]
    want = rapi.Engine(backend=backend, layout=layout).run(
        algo, pg_ref, **params)
    assert_same_run(want, sharded[2][0][f"{layout}-{backend}-{algo}"], algo)


@pytest.mark.parametrize("D", EXCHANGE_DS)
@pytest.mark.parametrize("op", ["min", "sum"])
def test_routed_scatter_combine_in_rounds(sharded, D, op):
    """A hot destination at cap 8 takes several rounds; rank 1 sends no
    lane at all; each rank's buffer equals a plain scatter of every
    rank's lanes."""
    for r in range(D):
        ex = sharded[D][r]["exchange"]
        got, want = ex[f"scatter_{op}"]
        np.testing.assert_array_equal(got, want)
        assert ex["scatter_rounds"][0] >= worker.HOT // worker.CAP
        assert ex["scatter_rounds"] == [ex["scatter_rounds"][0]] * 2


@pytest.mark.parametrize("D", EXCHANGE_DS)
def test_routed_fetch_in_rounds(sharded, D):
    """Requests at cap 8 in several rounds, out-of-range targets (-1,
    n_pad and beyond) and masked lanes read 0, rank 1 requests nothing."""
    for r in range(D):
        ex = sharded[D][r]["exchange"]
        got, want = ex["fetch"]
        np.testing.assert_array_equal(got, want)
        assert ex["fetch_rounds"][0] > 1
        if r == 1:
            assert got.shape == (0,)


@pytest.mark.parametrize("D", EXCHANGE_DS)
def test_sharded_gather_with_a_masked_row(parts, sharded, D):
    """Row gather with one row of every rank all masked (``inv == -1``)
    and a hot target: the values and the summed stats equal the
    single-device ``rr_gather`` on the global arrays."""
    pg = parts["hash-csr"][1]
    vals, targets, tmask = worker.gather_inputs(pg.M, pg.n_loc)
    m = pg.M // D
    tmask = tmask.copy()
    tmask[::m] = False
    out, stats = tchannels.rr_gather(
        torch.as_tensor(vals), torch.as_tensor(targets),
        torch.as_tensor(tmask), pg.M, pg.n_loc)
    got = np.concatenate([sharded[D][r]["exchange"]["gather"][0]
                          for r in range(D)])
    np.testing.assert_array_equal(got, out.numpy())
    assert not got[::m].any()
    for k, v in stats.items():
        total = sum(np.asarray(sharded[D][r]["exchange"]["gather"][1][k])
                    for r in range(D))
        np.testing.assert_array_equal(total, v.numpy(), err_msg=k)


def test_what_the_sharded_executor_refuses():
    _, g_t = graph_pair("powerlaw", 100, seed=0)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tapi.Engine(devices=2, device="cpu")
    pg = tstructs.partition(g_t, 2, device="cpu")
    from repro_torch.algorithms import hashmin
    with pytest.raises(RuntimeError, match="world_size=2"):
        hashmin.run(pg, tapi.EngineConfig(devices=2))
    from repro_torch.train import gcn
    with pytest.raises(RuntimeError, match="world_size=2"):
        gcn.run(pg, tapi.EngineConfig(devices=2))
    with pytest.raises(RuntimeError, match="world_size=2"):
        gcn.train_gcn(pg, devices=2)


def test_config_of_equals_the_reference(parts):
    for name, (pg_ref, pg_t) in parts.items():
        want = rapi.config_of(pg_ref, devices=2, backend="pallas")
        got = tapi.config_of(pg_t, devices=2, backend="pallas")
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def _msgs(text):
    return dict(re.findall(r"^\s+(msgs_\w+)\s+([\d,]+)$", text, re.M))


@pytest.mark.parametrize("algo", ["hashmin", "sv"])
def test_graph_run_devices_2_on_the_cpu(algo, capsys):
    """``graph_run --devices 2 --device cpu`` prints the single-device
    run's message counts and supersteps."""
    from repro_torch.launch import graph_run
    argv = ["--algo", algo, "--n", "2000", "--workers", "8", "--backend",
            "pallas", "--layout", "csr", "--device", "cpu"]
    graph_run.main(argv)
    one = capsys.readouterr().out
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.graph_run", *argv,
         "--devices", "2"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "devices=2" in proc.stdout
    assert _msgs(proc.stdout) == _msgs(one) and _msgs(one)
    runs = [re.search(r"\[run\] \w+: (\d+) supersteps", t).group(1)
            for t in (one, proc.stdout)]
    assert runs[0] == runs[1]
