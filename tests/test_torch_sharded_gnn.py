"""Port parity: the sharded GNN path over ``torch.distributed`` (gloo, CPU
processes) against the reference's single-device functions: the vector
broadcast, the chunked vector combine and the launcher here, the joins,
GCN training, the fetch and the placement rule in
``test_torch_sharded_gnn_join.py``, which shares this file's partitions,
inputs and spawn (``spawn_jobs``).

Spawned (``_torch_sharded_gnn_worker``, one spawn a world size a file
running its part of the matrix, 2 and 4 ranks), on the 1-D mesh, the
(2, 2) mesh of a host-affine partition, the pipeline at forced small caps
(``pipeline_chunks`` 64: routed rounds of 8 lanes, one-slot plan chunks)
and a split partition whose cut workers' shards lie on two ranks:

* feature-blocked broadcast: op sum/min/max x relay none/mul_w x csr and
  padded x dense and pallas x mirroring on/off x F in {1, 5}; some
  vertices inactive, and active ones whose features equal the op's
  identity.  min and max bitwise, sum within rtol 1e-5; every ``msgs_*``
  and ``per_worker_*`` integer-exact (summed over the ranks).  F=1 equals
  the sharded scalar payload: bitwise for min and max, for sums to
  round-off (the vector combine merges plan rows straight into blocks,
  the scalar one through segments first);
* with ``plan.VEC_CHUNK_BYTES`` shrunk, the sharded vector combine takes
  more than one launch a join; min and max stay bitwise, sums within
  rtol 1e-5.

Host-only: ``_pipeline_cap`` and ``_hier_caps`` with a feature width
equal the reference's expressions (and the scalar caps at width 1), and
``graph_run --algo gcn --devices`` prints the one-device loss line.
"""
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import _torch_sharded_gnn_worker as worker  # noqa: E402
from repro.core import channels as rch  # noqa: E402
from repro.core import exec as ref_exec  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.train import gcn as rgcn  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.launch import graph_run  # noqa: E402
from repro_torch.train import gcn as tgcn  # noqa: E402
from test_torch_graph import same_partition, to_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
M = 8
SPAWN_TIMEOUT_S = 300
SUM_RTOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
SPLIT = dict(layout="csr", balance="split", split_factor=1.1)
#: name -> (graph, partition keywords)
PARTS = {"hash-csr": ("pl", dict(layout="csr")),
         "hash-padded": ("pl", dict(layout="padded")),
         "host-csr": ("pl", dict(layout="csr", hosts=2)),
         "host-padded": ("pl", dict(layout="padded", hosts=2)),
         "split-csr": ("hub", SPLIT)}
GCN = dict(feat_dim=6, n_classes=4, epochs=3, lr=5e-2)
HIDDEN = 12
PIPE = 64          # pipeline_chunks of the forced-small-cap cases

#: world size -> [(name, partition, backend, devices, pipeline_chunks)]
BCAST = {
    2: [("1d-csr-pallas", "hash-csr", "pallas", 2, None),
        ("1d-csr-dense", "hash-csr", "dense", 2, None),
        ("1d-padded-pallas", "hash-padded", "pallas", 2, None),
        ("1d-padded-dense", "hash-padded", "dense", 2, None),
        ("pipe-csr-pallas", "hash-csr", "pallas", 2, PIPE),
        ("pipe-padded-dense", "hash-padded", "dense", 2, PIPE),
        ("split-pallas", "split-csr", "pallas", 2, None),
        ("split-dense", "split-csr", "dense", 2, None)],
    4: [("2x2-csr-pallas", "host-csr", "pallas", (2, 2), None),
        ("2x2-padded-dense", "host-padded", "dense", (2, 2), None),
        ("2x2-pipe-csr-pallas", "host-csr", "pallas", (2, 2), PIPE),
        ("2x2-pipe-csr-dense", "host-csr", "dense", (2, 2), PIPE),
        ("2x2-split-pallas", "split-csr", "pallas", (2, 2), None),
        ("1d4-padded-pallas", "hash-padded", "pallas", 4, None)],
}
#: world size -> [(name, partition, backend, devices, pipeline, hidden)]
GCN_CASES = {
    2: [("gcn-1d", "hash-csr", "pallas", 2, False, HIDDEN),
        ("gcn-1d-hidden-M", "hash-csr", "pallas", 2, False, M),
        ("gcn-padded-dense", "hash-padded", "dense", 2, False, HIDDEN),
        ("gcn-split", "split-csr", "pallas", 2, False, HIDDEN),
        ("gcn-pipe", "hash-csr", "pallas", 2, True, HIDDEN)],
    4: [("gcn-2x2", "host-csr", "pallas", (2, 2), False, HIDDEN),
        ("gcn-2x2-pipe", "host-csr", "pallas", (2, 2), True, HIDDEN),
        ("gcn-2x2-split", "split-csr", "pallas", (2, 2), False, HIDDEN)],
}
#: world size -> [(partition, backend, devices)] of gspmm, grad and fetch
JOINS = {2: [("hash-csr", "pallas", 2), ("hash-padded", "dense", 2),
             ("split-csr", "pallas", 2)],
         4: [("host-csr", "pallas", (2, 2)), ("split-csr", "dense", (2, 2))]}
#: world size -> [(partition, devices, pipeline_chunks)] of the chunk case
CHUNKS = {2: [("hash-csr", 2, None), ("hash-csr", 2, PIPE)],
          4: [("host-csr", (2, 2), None)]}
WORLDS = (2, 4)
IDENT = {"sum": 0.0, "min": np.inf, "max": -np.inf}


def _graph(kind):
    if kind == "pl":
        g = ref_gen.powerlaw(300, avg_deg=6, seed=5, weighted=True)
    else:
        # hub-heavy: balance="split" cuts workers, and at D=2 a cut
        # worker's shards lie on both ranks
        g = ref_gen.powerlaw(300, avg_deg=6, seed=2, alpha=1.5,
                             weighted=True)
    return rgcn.normalize_adjacency(g.symmetrized())


@pytest.fixture(scope="module")
def parts():
    graphs = {k: _graph(k) for k in ("pl", "hub")}
    return {name: same_partition(graphs[g], M, tau=10 if g == "hub" else 8,
                                 seed=1, **kw)
            for name, (g, kw) in PARTS.items()}


def _bcast_inputs(pg, op, F):
    """(M, n_loc, F) features and (M, n_loc) activity: a quarter of the
    vertices inactive; active vertices whose first feature is the op's
    identity (the busiest, which are mirrored) and others whose every
    feature is."""
    rng = np.random.RandomState(11 + F + 3 * worker.OPS.index(op))
    x = rng.randn(pg.M, pg.n_loc, F).astype(np.float32)
    act = rng.rand(pg.M, pg.n_loc) < 0.75
    deg = np.asarray(pg.deg).reshape(-1)
    live = np.flatnonzero(act.reshape(-1) & np.asarray(pg.vmask
                                                       ).reshape(-1))
    hubs = live[np.argsort(-deg[live], kind="stable")[:4]]
    x.reshape(-1, F)[hubs, 0] = IDENT[op]
    x.reshape(-1, F)[live[1::17]] = IDENT[op]
    return x, act


def _inputs(parts):
    out = {}
    for name, (pg_ref, _) in parts.items():
        for op in worker.OPS:
            for F in worker.FEATS:
                out[(name, op, F)] = _bcast_inputs(pg_ref, op, F)
        rng = np.random.RandomState(5)
        shape = (pg_ref.M, pg_ref.n_loc, 5)
        out[("gspmm", name)] = rng.randn(*shape).astype(np.float32)
        out[("grad", name)] = (rng.randn(*shape).astype(np.float32),
                               rng.randn(*shape).astype(np.float32))
        n_pad = pg_ref.M * pg_ref.n_loc
        ids = rng.randint(0, n_pad, (pg_ref.M, 9)).astype(np.int32)
        ids[:, :3] = 7                              # a hot row
        fmask = rng.rand(pg_ref.M, 9) < 0.8
        fmask[1] = False                            # a row with none
        out[("fetch", name)] = (rng.randn(*shape).astype(np.float32), ids,
                                fmask)
        for hidden in (HIDDEN, M):
            p = rgcn.init_gcn_params(pg_ref, GCN["feat_dim"], hidden,
                                     GCN["n_classes"], seed=3)
            out[("gcn", name, hidden)] = {k: np.asarray(v)
                                          for k, v in p.items()}
    return out


def _jobs(D, kinds):
    jobs = []
    for name, part, be, dev, pc in BCAST[D]:
        jobs.append(("bcast", name, dict(part=part, backend=be, devices=dev,
                                         pipeline_chunks=pc)))
    for name, part, be, dev, pipe, hidden in GCN_CASES[D]:
        jobs.append(("gcn", name, dict(GCN, part=part, backend=be,
                                       devices=dev, pipeline=pipe,
                                       hidden=hidden)))
    for part, be, dev in JOINS[D]:
        f = dict(part=part, backend=be, devices=dev)
        for kind in ("gspmm", "grad", "fetch"):
            jobs.append((kind, f"{kind}-{part}-{be}", f))
    for part, dev, pc in CHUNKS[D]:
        jobs.append(("chunks", f"chunks-{part}-{pc}",
                     dict(part=part, devices=dev, pipeline_chunks=pc)))
    jobs.append(("apply", "apply", dict(part="hash-csr", hidden=M,
                                        devices=D)))
    return [j for j in jobs if j[0] in kinds]


@pytest.fixture(scope="module")
def inputs(parts):
    return _inputs(parts)


def spawn_jobs(parts, inputs, tmp_path_factory, kinds):
    """{D: [rank 0's results, rank 1's, ...]} of the jobs of ``kinds``:
    one spawn a world size."""
    from repro_torch.graph import structs as tstructs
    out = {}
    for D in WORLDS:
        tmp = tmp_path_factory.mktemp(f"gnn{D}")
        jobs = _jobs(D, kinds)
        used = {f["part"] for _, _, f in jobs}
        spec = {"partitions": {k: tstructs.to_numpy(parts[k][1])
                               for k in used},
                "inputs": inputs, "jobs": jobs}
        with open(tmp / "spec.pkl", "wb") as fh:
            pickle.dump(spec, fh)
        graph_run.spawn_ranks(worker.rank_main,
                              (D, str(tmp / "store"), str(tmp / "spec.pkl"),
                               str(tmp / "out")), D, SPAWN_TIMEOUT_S)
        out[D] = []
        for r in range(D):
            with open(tmp / f"out.{r}", "rb") as fh:
                out[D].append(pickle.load(fh))
    return out


@pytest.fixture(scope="module")
def sharded(parts, inputs, tmp_path_factory):
    """The broadcast and chunked-combine jobs' results."""
    return spawn_jobs(parts, inputs, tmp_path_factory, ("bcast", "chunks"))


_ref_cache = {}


def _ref_bcast(parts, inputs, part, backend, op, relay, mir, F):
    key = (part, backend, op, relay, mir, F)
    if key not in _ref_cache:
        x, act = inputs[(part, op, max(F, 1))]
        vals = x[..., 0] if F == 0 else x
        _ref_cache[key] = rch.broadcast(parts[part][0], jnp.asarray(vals),
                                        jnp.asarray(act), op, relay=relay,
                                        use_mirroring=mir, backend=backend)
    return _ref_cache[key]


def _assert_values(got, want, op, err_msg=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, err_msg
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=1e-6,
                                   err_msg=err_msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)


def _assert_stats(ranks, want, err_msg=""):
    assert set(ranks[0]) == set(want), err_msg
    for k in want:
        total = sum(np.asarray(r[k], np.int64) for r in ranks)
        np.testing.assert_array_equal(total, to_np(want[k]).astype(np.int64),
                                      err_msg=f"{err_msg} {k}")


BCAST_IDS = [(D, c[0], op, F) for D in WORLDS for c in BCAST[D]
             for op in worker.OPS for F in worker.FEATS]


@pytest.mark.parametrize("D,name,op,F", BCAST_IDS,
                         ids=[f"D{D}-{n}-{op}-F{F}"
                              for D, n, op, F in BCAST_IDS])
def test_vector_broadcast_equal_one_device(parts, inputs, sharded, D, name,
                                           op, F):
    _, part, be, _, _ = next(c for c in BCAST[D] if c[0] == name)
    for relay in worker.RELAYS:
        for mir in (True, False):
            tag = f"{name} {op} {relay} mirroring={mir} F={F}"
            runs = [sharded[D][r][name][(op, relay, mir, F)]
                    for r in range(D)]
            got = np.concatenate([run[0] for run in runs])
            want, wstats = _ref_bcast(parts, inputs, part, be, op, relay,
                                      mir, F)
            _assert_values(got, want, op, tag)
            _assert_stats([run[1] for run in runs], wstats, tag)
            if F == 1:
                scalar = np.concatenate(
                    [sharded[D][r][name][(op, relay, mir, 0)][0]
                     for r in range(D)])
                _assert_values(got[..., 0], scalar, op, f"{tag} vs scalar")
                for r in range(D):
                    for k, v in runs[r][1].items():
                        np.testing.assert_array_equal(
                            v, sharded[D][r][name][(op, relay, mir, 0)][1][k])


CHUNK_IDS = [(D, part, pc) for D in WORLDS for part, _, pc in CHUNKS[D]]


@pytest.mark.parametrize("D,part,pc", CHUNK_IDS,
                         ids=[f"D{D}-{p}-{pc}" for D, p, pc in CHUNK_IDS])
@pytest.mark.parametrize("op", worker.OPS)
def test_chunked_vector_combine(parts, inputs, sharded, D, part, pc, op):
    """With ``plan.VEC_CHUNK_BYTES`` shrunk each rank's join runs its
    plan rows in several vector launches of at most the chunk's rows."""
    want, wstats = _ref_bcast(parts, inputs, part, "pallas", op, "mul_w",
                              True, 5)
    runs = [sharded[D][r][f"chunks-{part}-{pc}"] for r in range(D)]
    _assert_values(np.concatenate([x[op][0] for x in runs]), want, op)
    _assert_stats([x[op][1] for x in runs], wstats)
    for x in runs:
        calls = x[op][2]
        n_rows, eb, nb = x["rows"]["eg"]
        step = max(1, worker.SMALL_CHUNK_BYTES // ((eb + nb) * 5 * 4))
        assert len(calls) > 2 and max(calls) <= step, (calls, step)
        if pc is None:
            # every row of the eg and mirror plans, once
            assert sum(calls) == n_rows + x["rows"]["mir"][0]


# ---------------------------------------------------------------------------
# host-only: the caps with a feature width
# ---------------------------------------------------------------------------

def _sg(pipeline, chunks, H=1, T=0, hint_w=None, hint_h=None):
    return SimpleNamespace(pipeline=pipeline, pipeline_chunks=chunks, H=H,
                           T=T, cap_hint_w=hint_w, cap_hint_h=hint_h)


#: the scalar executor's caps, before feature widths, at feat_elems=1:
#: (pipeline, chunks, cap) -> cap
SCALAR_CAPS = {(False, 1, 100): 100, (True, 1, 100): 100,
             (True, 2, 100): 56, (True, 2, 9): 8, (True, 3, 1000): 336,
             (True, 64, 100): 8, (True, 2, 5): 5}


@pytest.mark.parametrize("feat", [1, 5, 64])
@pytest.mark.parametrize("pipeline,chunks,cap", sorted(SCALAR_CAPS))
def test_pipeline_cap_with_features_equal(feat, pipeline, chunks, cap):
    sg = _sg(pipeline, chunks)
    got = texec._pipeline_cap(sg, cap, feat)
    assert got == ref_exec._pipeline_cap(sg, cap, feat)
    if feat == 1:
        assert got == texec._pipeline_cap(sg, cap) == \
            SCALAR_CAPS[(pipeline, chunks, cap)]
    else:
        assert got <= texec._pipeline_cap(sg, cap)


@pytest.mark.parametrize("feat", [1, 5, 64])
@pytest.mark.parametrize("mesh,hints", [((2, 2), (None, None)),
                                        ((2, 4), (40, 90)),
                                        ((4, 2), (7, 300))])
@pytest.mark.parametrize("cap", [None, (16, 24)])
@pytest.mark.parametrize("pipeline", [False, True])
def test_hier_caps_with_features_equal(feat, mesh, hints, cap, pipeline):
    H, T = mesh
    sg = _sg(pipeline, 2, H, T, *hints)
    for L in (0, 37, 1000):
        got = texec._hier_caps(sg, L, cap, feat)
        assert got == ref_exec._hier_caps(sg, L, cap, feat)
        if feat == 1:
            assert got == texec._hier_caps(sg, L, cap)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _gcn_line(text):
    m = re.search(r"\[gcn\] F=\d+ hidden=\d+ classes=\d+: loss "
                  r"([\d.]+) -> ([\d.]+) over (\d+) epochs", text)
    assert m is not None, text[-2000:]
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


@pytest.mark.parametrize("extra", [["--devices", "2"],
                                   ["--devices", "4", "--hosts", "2",
                                    "--pipeline"]],
                         ids=["devices2", "mesh2x2-pipeline"])
def test_graph_run_gcn_devices_on_the_cpu(extra):
    """``graph_run --algo gcn --devices D [--hosts H] [--pipeline]``
    prints rank 0's ``[gcn]`` loss line, equal within the GCN bound to
    the one-device run on the same partition."""
    argv = ["--algo", "gcn", "--n", "1500", "--workers", "8", "--backend",
            "pallas", "--layout", "csr", "--device", "cpu", "--epochs", "3",
            "--feat-dim", "8", "--hidden", "16"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.graph_run", *argv,
         *extra], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    first, last, epochs = _gcn_line(proc.stdout)
    assert epochs == 3 and "msgs_total" in proc.stdout
    hosts = 2 if "--hosts" in extra else None
    gw = tgcn.normalize_adjacency(graph_run.make_graph(
        "powerlaw", 1500, 0).symmetrized())
    _, _, tau = graph_run.build("powerlaw", 1500, 0, 8, "auto",
                                layout="csr", hosts=hosts, device="cpu")
    from repro_torch.api import Engine
    eng = Engine(backend="pallas", layout="csr", hosts=hosts,
                 use_mirroring=tau is not None, device="cpu")
    one = eng.run("gcn", eng.partition(gw, 8, tau=tau, seed=0), feat_dim=8,
                  hidden=16, n_classes=8, epochs=3, seed=0).history
    # the line prints 4 decimals
    np.testing.assert_allclose([first, last], [one[0], one[-1]],
                               rtol=LOSS_RTOL, atol=5e-5 + LOSS_ATOL)
