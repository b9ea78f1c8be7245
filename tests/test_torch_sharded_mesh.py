"""Port parity: the sharded executor's load-balanced and hierarchical modes
over ``torch.distributed`` (gloo, CPU processes) against one device.

Spawned (``_torch_sharded_worker``, one spawn a world size running its
whole matrix):

* ``balance="split"``: the physical shards placed on the ranks by edge
  load, at D = 2 and 4, csr x {dense, pallas}, the six algorithms;
* the (hosts, per_host) mesh: (2, 2) on a host-affine partition
  (``hosts=2``) on csr/pallas and padded/dense, the six algorithms;
  (1, 2) and (2, 1) for Hash-Min and S-V; split on (2, 2);
* the pipeline: at D = 2 (csr/pallas and padded/dense) and on (2, 2), the
  six algorithms; and the routed scatter and fetch at forced caps of 1
  and 8, pipelined against not pipelined, bitwise.

Contract: min, max and integer state bitwise, PageRank within rtol 1e-5,
MSF's total weight within 1e-6; every ``msgs_*`` and ``per_worker_*``
equal; the same supersteps.  Each run is held to the port's single-device
run on the same partition; Hash-Min, S-V, PageRank and MSF also to the
reference's single-device run.

Host-only (no spawn): the split device bounds and loads, the 2-D cap
hints, the hierarchical plan and fetch tables, the pipeline's chunk
tables, whole ``_shard_graph`` builds, ``crossness_report`` and
``exchange_volume_report`` equal the reference's on hash, split and
host-affine partitions, and the tables route every segment and slot
exactly once.
"""
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
from repro.core import exec as ref_exec  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from repro_torch.launch import graph_run  # noqa: E402
from test_torch_graph import graph_pair, same_partition  # noqa: E402
from test_torch_sharded import (  # noqa: E402
    ALGOS, _msgs, assert_same_run, assert_tree_equal)

ROOT = Path(__file__).resolve().parents[1]

M = 8
NB = 32                       # the reference's block width off the TPU
SPAWN_TIMEOUT_S = 300
SPLIT = dict(layout="csr", balance="split", split_factor=1.1)
#: name -> (graph, partition keywords)
PARTS = {"hash-csr": ("pl", dict(layout="csr")),
         "hash-padded": ("pl", dict(layout="padded")),
         "host-csr": ("pl", dict(layout="csr", hosts=2)),
         "host-padded": ("pl", dict(layout="padded", hosts=2)),
         "split-csr": ("hub", SPLIT)}
CSR_BACKENDS = [("csr", "dense"), ("csr", "pallas")]
BOTH = [("csr", "pallas"), ("padded", "dense")]


def _jobs(D):
    jobs = {}

    def add(tag, part, cfg, algos=ALGOS):
        for algo, params in algos:
            jobs[f"{tag}-{algo}"] = (part, cfg, algo, params)

    hub = [a for a in ALGOS if a[0] in ("hashmin", "sv")]
    for lay, b in CSR_BACKENDS:
        add(f"split{D}-{b}", "split-csr", dict(SPLIT, backend=b))
    if D == 2:
        for lay, b in BOTH:
            add(f"pipe2-{lay}-{b}", f"hash-{lay}",
                dict(layout=lay, backend=b, pipeline=True))
        for mesh in ((1, 2), (2, 1)):
            add(f"mesh{mesh[0]}x{mesh[1]}", "hash-csr",
                dict(layout="csr", backend="pallas", devices=mesh), hub)
    if D == 4:
        for lay, b in BOTH:
            add(f"mesh2x2-{lay}-{b}", f"host-{lay}",
                dict(layout=lay, backend=b, hosts=2, devices=(2, 2)))
        add("mesh2x2-pipe", "host-csr",
            dict(layout="csr", backend="pallas", hosts=2, devices=(2, 2),
                 pipeline=True))
        add("mesh2x2-split", "split-csr",
            dict(SPLIT, backend="pallas", devices=(2, 2)))
    return jobs


WORLD = {D: _jobs(D) for D in (2, 4)}
PIPELINED = {2: ("hash-csr", 2), 4: ("host-csr", (2, 2))}
CASES = [(D, name) for D, jobs in WORLD.items() for name in jobs]


def _graph(kind):
    if kind == "pl":
        return graph_pair("powerlaw", 300, seed=5, weighted=True)[0]
    # hub-heavy: the hottest vertices outweigh a worker's fair share, so
    # balance="split" cuts workers into several physical shards
    return ref_gen.powerlaw(300, avg_deg=6, seed=2, alpha=1.5,
                            weighted=True).symmetrized()


@pytest.fixture(scope="module")
def parts():
    graphs = {k: _graph(k) for k in ("pl", "hub")}
    return {name: same_partition(graphs[g], M, tau=10 if g == "hub" else 8,
                                 seed=1, **kw)
            for name, (g, kw) in PARTS.items()}


@pytest.fixture(scope="module")
def sharded(parts, tmp_path_factory):
    """{D: [rank 0's results, rank 1's, ...]}: one spawn a world size."""
    out = {}
    for D, jobs in WORLD.items():
        tmp = tmp_path_factory.mktemp(f"world{D}")
        used = {part for part, _, _, _ in jobs.values()}
        used.add(PIPELINED[D][0])
        spec = {"partitions": {k: tstructs.to_numpy(parts[k][1])
                               for k in used},
                "jobs": jobs, "pipelined": PIPELINED[D]}
        with open(tmp / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        graph_run.spawn_ranks(worker.rank_main,
                              (D, str(tmp / "store"), str(tmp / "spec.pkl"),
                               str(tmp / "out")), D, SPAWN_TIMEOUT_S)
        out[D] = []
        for r in range(D):
            with open(tmp / f"out.{r}", "rb") as f:
                out[D].append(pickle.load(f))
    return out


_single_cache = {}


def single(parts, part, cfg, algo, params):
    """The port's single-device run of one job (cached): its config less
    the sharded executor's fields."""
    cfg = {k: v for k, v in cfg.items() if k not in ("devices", "pipeline")}
    key = (part, tuple(sorted(cfg.items())), algo, repr(params))
    if key not in _single_cache:
        pg = parts[part][1]
        _single_cache[key] = tapi.Engine(device="cpu", **cfg).run(
            algo, pg, **worker.job_params(pg, params))
    return _single_cache[key]


@pytest.mark.parametrize("D,name", CASES,
                         ids=[f"D{D}-{name}" for D, name in CASES])
def test_mesh_split_pipeline_equal_one_device(parts, sharded, D, name):
    part, cfg, algo, params = WORLD[D][name]
    got = sharded[D][0][name]
    assert_same_run(single(parts, part, cfg, algo, params), got, algo)
    info = got["sharded"]
    loop = 0 if algo == "attr_bcast" else got["n"]
    # one host read a superstep, one a routed join and one an inter-host
    # leg (its round count, read once an outer round)
    assert info["host_reads"] == loop + len(info["rounds"])
    if isinstance(cfg.get("devices"), tuple) and algo in ("sv", "msf"):
        assert info["inner_rounds"]
    else:
        assert len(info["inner_rounds"]) <= len(info["rounds"])
    for r in range(1, D):
        other = sharded[D][r][name]
        assert other["n"] == got["n"]
        assert_tree_equal(other["state"], got["state"])


@pytest.mark.parametrize("name,algo", [
    ("split2-pallas", "hashmin"), ("split2-pallas", "sv"),
    ("split2-pallas", "pagerank"), ("split2-dense", "msf"),
    ("mesh2x2-csr-pallas", "hashmin"), ("mesh2x2-csr-pallas", "sv"),
    ("mesh2x2-pipe", "pagerank"), ("mesh2x2-padded-dense", "msf")])
def test_mesh_split_pipeline_equal_the_reference(parts, sharded, name, algo):
    D = 2 if name.startswith("split2") else 4
    part, cfg, _, params = WORLD[D][f"{name}-{algo}"]
    pg_ref = parts[part][0]
    want = rapi.Engine(backend=cfg["backend"], layout=cfg["layout"]).run(
        algo, pg_ref, **dict(ALGOS)[algo])
    assert_same_run(want, sharded[D][0][f"{name}-{algo}"], algo)


@pytest.mark.parametrize("D", sorted(PIPELINED))
@pytest.mark.parametrize("cap", worker.PIPE_CAPS)
@pytest.mark.parametrize("what", ["scatter_min", "scatter_sum", "fetch"])
def test_pipelined_exchanges_at_forced_caps(parts, sharded, D, cap, what):
    """The routed scatter and fetch at cap 1 (one lane a round: the most
    rounds through the double buffer) and 8 (a hot destination overflows
    mid-pipeline), pipelined and not: bitwise equal, and equal to a plain
    scatter / read of every rank's lanes."""
    pg = parts[PIPELINED[D][0]][1]
    n_pad, loc_n = pg.n_pad, pg.n_pad // D
    glob = np.arange(n_pad, dtype=np.int32) * 5 - 7
    for r in range(D):
        ex = sharded[D][r]["pipelined"]
        seq, pipe = ex[(False, cap, what)], ex[(True, cap, what)]
        np.testing.assert_array_equal(pipe, seq)
        t, v, ok = worker.lanes_of(r, n_pad, loc_n)
        if what == "fetch":
            tf = t.copy()
            if len(tf):
                tf[worker.HOT:worker.HOT + 3] = [-1, n_pad, n_pad + 5]
            inb = ok & (tf >= 0) & (tf < n_pad)
            want = np.where(inb, glob[np.clip(tf, 0, n_pad - 1)], 0)
        else:
            op = what.split("_")[1]
            want = np.full(n_pad, worker.IMAX if op == "min" else 0,
                           np.int32)
            for s in range(D):
                ts, vs, oks = worker.lanes_of(s, n_pad, loc_n)
                (np.minimum if op == "min" else np.add).at(
                    want, ts[oks], vs[oks])
            want = want[r * loc_n:(r + 1) * loc_n]
        np.testing.assert_array_equal(seq, want)
        rounds = ex[(True, cap, "rounds")]
        assert rounds == ex[(False, cap, "rounds")]
        if cap == 1:
            assert max(rounds) > 2


# ---------------------------------------------------------------------------
# host tables against the reference, no process group
# ---------------------------------------------------------------------------

MESHES = [(1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (1, 8), (8, 1)]
TABLE_PARTS = ["hash-csr", "host-csr", "split-csr", "host-padded"]


def _mesh_id(x):
    return f"{x[0]}x{x[1]}" if isinstance(x, tuple) else str(x)


@pytest.mark.parametrize("devices", [1, 2, 4, 8, (2, 2), (2, 4)],
                         ids=_mesh_id)
@pytest.mark.parametrize("part", ["hash-csr", "host-csr", "split-csr"])
def test_device_bounds_and_loads_equal(parts, part, devices):
    pg_ref, pg_t = parts[part]
    want = ref_exec.device_edge_bounds(pg_ref, devices)
    got = texec.device_edge_bounds(pg_t, devices)
    assert (got["phys"] is None) == (want["phys"] is None)
    for k in want:
        if want[k] is not None:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(texec.device_edge_loads(pg_t, devices),
                                  ref_exec.device_edge_loads(pg_ref, devices))
    if part == "split-csr":
        # the placement is edge-balanced: no device carries more than the
        # whole-worker placement's heaviest device
        D = texec._normalize_devices(devices)[0]
        loads = texec.device_edge_loads(pg_t, devices)
        assert loads.sum() == pg_t.edge_load().sum()
        if D > 1:
            whole = np.diff(texec.csr_device_bounds(pg_t.eg_off, M, D)) \
                + np.diff(texec.csr_device_bounds(pg_t.mir_eoff, M, D))
            assert loads.max() <= whole.max()


def test_split_partition_splits_workers(parts):
    pg = parts["split-csr"][1]
    assert pg.M_phys > pg.M
    pb = texec.device_edge_bounds(pg, 2)["phys"]
    # a logical worker's shards straddle the two devices
    assert pg.phys_log[pb[1] - 1] == pg.phys_log[pb[1]]


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("part", ["hash-csr", "host-csr", "split-csr"])
def test_cap_hints_2d_equal(parts, part, mesh):
    pg_ref, pg_t = parts[part]
    D = mesh[0] * mesh[1]
    assert texec._cap_hints_2d(pg_t, D, *mesh) == \
        ref_exec._cap_hints_2d(pg_ref, D, *mesh)


def _assert_tables_equal(meta_g, arr_g, meta_w, arr_w):
    assert meta_g == meta_w
    assert set(arr_g) == set(arr_w)
    for k in arr_w:
        assert arr_g[k].dtype == arr_w[k].dtype, k
        np.testing.assert_array_equal(arr_g[k], arr_w[k], err_msg=k)


@pytest.mark.parametrize("chunks", [None, 2, 3])
@pytest.mark.parametrize("kind", ["eg", "all", "mir"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1), (2, 4)],
                         ids=_mesh_id)
@pytest.mark.parametrize("part", TABLE_PARTS)
def test_hier_plan_tables_equal(parts, part, mesh, kind, chunks):
    pg_ref, pg_t = parts[part]
    D = mesh[0] * mesh[1]
    m = M // D
    want = ref_exec._stack_plans(ref_exec._device_plans(pg_ref, D, kind, NB),
                                 m, chunks=chunks, hier=mesh)
    got = texec._stack_plans(texec._device_plans(pg_t, D, kind, NB), m,
                             chunks=chunks, hier=mesh)
    _assert_tables_equal(*got, *want)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1), (2, 4)],
                         ids=_mesh_id)
@pytest.mark.parametrize("part", ["host-csr", "split-csr"])
def test_hier_plan_exchange_equals_the_flat_one(parts, part, mesh):
    """Route random min-combined segment partials through the two legs
    (host numpy: leg 1, the intermediate combine, leg 2) and through the
    1-D tables: every device's local blocks agree, so every real segment
    crosses each leg exactly once, combined."""
    _, pg_t = parts[part]
    H, T = mesh
    D = H * T
    plans = texec._device_plans(pg_t, D, "eg", NB)
    m = M // D
    meta, a = texec._stack_plans(plans, m, hier=mesh)
    _, flat = texec._stack_plans(plans, m)
    rng = np.random.RandomState(3)
    seg = [rng.randint(0, 1000, (meta["n_segs"], NB)) for _ in range(D)]
    big = np.iinfo(np.int64).max
    nbl = m * plans[0].B_per_w
    want = np.full((D, nbl, NB), big)
    for d in range(D):
        for s in range(D):
            v = flat["xval"][s, d]
            np.minimum.at(want[d], flat["rblk"][d, s][flat["rval"][d, s]],
                          seg[s][flat["xseg"][s, d][v]])
    inter = np.full((D, meta["n_iseg"], NB), big)
    for i in range(D):
        h, t2 = divmod(i, T)
        for t1 in range(T):
            s = h * T + t1
            v = a["x1val"][s, t2]
            assert (v == a["ival"][i, t1]).all()
            np.minimum.at(inter[i], a["iscat"][i, t1][v],
                          seg[s][a["x1seg"][s, t2][v]])
    got = np.full((D, nbl, NB), big)
    for o in range(D):
        h2, t2 = divmod(o, T)
        for h in range(H):
            i = h * T + t2
            v = a["x2val"][i, h2]
            assert (v == a["r2val"][o, h]).all()
            np.minimum.at(got[o], a["r2blk"][o, h][v],
                          inter[i][a["x2seg"][i, h2][v]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 3), (3, 1), (2, 3)],
                         ids=_mesh_id)
def test_hier_fetch_plan_equal_and_exact(mesh):
    """The gateway's two legs deliver every needed slot to its consumer,
    each slot crossing hosts once per consuming host."""
    H, T = mesh
    D = H * T
    rng = np.random.RandomState(D)
    loc_n = 23
    need = [np.unique(rng.randint(0, D * loc_n, rng.randint(0, 30)))
            for _ in range(D)]
    if D > 1:
        need[1] = np.zeros(0, np.int64)            # a device needing nothing
    meta_w, arr_w = ref_exec._build_fetch_plan(need, D, loc_n, hier=mesh)
    meta_g, arr_g = texec._build_fetch_plan(need, D, loc_n, hier=mesh)
    _assert_tables_equal(meta_g, arr_g, meta_w, arr_w)
    vals = np.arange(D * loc_n) * 7 + 1
    gw = np.full((D, meta_g["n_gw"]), -1)
    for o in range(D):
        ho, to = divmod(o, T)
        for hc in range(H):
            g = hc * T + to
            snd = arr_g["a_send"][o, hc]
            pos = arr_g["a_recv"][g, ho]
            assert ((snd >= 0) == (pos >= 0)).all()
            gw[g, pos[pos >= 0]] = vals[snd[snd >= 0] + o * loc_n]
    for d in range(D):
        hc, tc = divmod(d, T)
        got = np.full(len(need[d]), -1)
        for to in range(T):
            g = hc * T + to
            snd = arr_g["b_send"][g, tc]
            pos = arr_g["b_recv"][d, to]
            assert ((snd >= 0) == (pos >= 0)).all()
            got[pos[pos >= 0]] = gw[g, snd[snd >= 0]]
        np.testing.assert_array_equal(got, vals[need[d]])
    # leg A carries each slot once per host that needs it
    per_host = [np.unique(np.concatenate(need[h * T:(h + 1) * T]))
                for h in range(H)]
    assert int((arr_g["a_send"] >= 0).sum()) == sum(len(x) for x in per_host)


@pytest.mark.parametrize("chunks", [1, 2, 3, 64])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("part", ["hash-csr", "split-csr", "hash-padded"])
def test_chunk_tables_equal_and_partition(parts, part, D, chunks):
    """The pipeline's chunk tables equal the reference's, and every real
    exchange slot and plan row lands in exactly one chunk with the same
    receive blocks as the unchunked tables (chunks=64 beyond xcap: one
    slot a chunk)."""
    pg_ref, pg_t = parts[part]
    m = M // D
    plans = texec._device_plans(pg_t, D, "eg", NB)
    meta_c, a_c = texec._stack_plans(plans, m, chunks=chunks)
    _assert_tables_equal(meta_c, a_c, *ref_exec._stack_plans(
        ref_exec._device_plans(pg_ref, D, "eg", NB), m, chunks=chunks))
    meta_s, a_s = texec._stack_plans(plans, m)
    C, ccap = meta_c["n_chunks"], meta_c["ccap"]
    assert C == -(-meta_s["xcap"] // ccap)
    for d in range(D):
        assert a_c["cxval"][d].sum() == a_s["xval"][d].sum()
        assert a_c["crval"][d].sum() == a_s["rval"][d].sum()
        assert (sorted(a_c["crblk"][d][a_c["crval"][d]].tolist())
                == sorted(a_s["rblk"][d][a_s["rval"][d]].tolist()))
        rows = a_c["crow"][d][a_c["crow_ok"][d]]
        assert sorted(rows.tolist()) == list(range(plans[d].n_rows))
        assert (a_c["crow_seg"][d][a_c["crow_ok"][d]] < meta_c["cs"]).all()


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("devices", [2, 4, (2, 2), (1, 4)], ids=_mesh_id)
@pytest.mark.parametrize("part", TABLE_PARTS)
def test_shard_graph_equal(parts, part, devices, pipeline):
    pg_ref, pg_t = parts[part]
    kinds = ("eg", "mir", "all")
    meta_w, arr_w, _ = ref_exec._shard_graph(pg_ref, devices, kinds,
                                             pipeline=pipeline)
    meta_g, arr_g = texec._shard_graph(pg_t, devices, kinds, NB,
                                       pipeline=pipeline)
    assert set(meta_g) == set(meta_w)
    for k in meta_w:
        if k in ("p_bounds", "device_edge_load"):
            np.testing.assert_array_equal(meta_g[k], meta_w[k], err_msg=k)
        else:
            assert meta_g[k] == meta_w[k], k
    assert set(arr_g) == set(arr_w)
    for k in arr_w:
        np.testing.assert_array_equal(np.asarray(arr_g[k]),
                                      np.asarray(arr_w[k]), err_msg=k)


@pytest.mark.parametrize("devices", [None, 1, 2, 4, (2, 2), (2, 4), (4, 2)],
                         ids=lambda x: "none" if x is None else _mesh_id(x))
@pytest.mark.parametrize("part", ["hash-csr", "host-csr", "split-csr"])
def test_crossness_report_equal(parts, part, devices):
    pg_ref, pg_t = parts[part]
    assert texec.crossness_report(pg_t, devices) == \
        ref_exec.crossness_report(pg_ref, devices)


@pytest.mark.parametrize("kinds", [(), ("eg", "mir"), ("all",)],
                         ids=["none", "eg-mir", "all"])
@pytest.mark.parametrize("devices", [2, 4, (2, 2), (2, 4)], ids=_mesh_id)
@pytest.mark.parametrize("part", TABLE_PARTS)
def test_exchange_volume_report_equal(parts, part, devices, kinds):
    pg_ref, pg_t = parts[part]
    want = ref_exec.exchange_volume_report(pg_ref, devices, kinds)
    got = texec.exchange_volume_report(pg_t, devices, kinds, nb=NB)
    assert got == want
    if isinstance(devices, tuple) and kinds:
        # the per-level combine: the residue crossing hosts is below the
        # 1-D mesh's all-pairs volume between the same devices
        flat = texec.exchange_volume_report(pg_t, devices[0] * devices[1],
                                            kinds, nb=NB)
        assert got["cross_host"] < flat["total"]


@pytest.mark.parametrize("algo", ["hashmin", "sv"])
def test_graph_run_mesh_pipelined_on_the_cpu(algo):
    """``graph_run --devices 4 --hosts 2 --pipeline --device cpu`` prints
    the message counts and supersteps of the one-device run on the same
    host-affine partition, and the static exchange volume."""
    argv = ["--algo", algo, "--n", "2000", "--workers", "8", "--backend",
            "pallas", "--layout", "csr", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.graph_run", *argv,
         "--devices", "4", "--hosts", "2", "--pipeline"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "devices=2x2" in proc.stdout and "pipeline=on" in proc.stdout
    _, pg, tau = graph_run.build("powerlaw", 2000, 0, 8, "auto",
                                 layout="csr", hosts=2, device="cpu")
    one = tapi.Engine(backend="pallas", layout="csr", hosts=2,
                      use_mirroring=tau is not None, device="cpu").run(
                          algo, pg)
    got = _msgs(proc.stdout)
    assert got and {k: int(v.replace(",", "")) for k, v in got.items()} \
        == {k: int(v) for k, v in one.stats.items() if k in got}
    n = re.search(r"\[run\] \w+: (\d+) supersteps", proc.stdout).group(1)
    assert int(n) == one.n_supersteps
    vol = re.search(r"\[exchange\] devices=2x2: .* cross_host=([\d,]+)",
                    proc.stdout)
    assert vol is not None
    assert "[balance] device edge-load" in proc.stdout
