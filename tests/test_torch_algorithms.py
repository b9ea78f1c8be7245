"""Port parity: Hash-Min, PageRank and SSSP through ``Engine.run``.

Both packages run on the SAME partition (the reference's, carried into the
port with ``from_numpy``).  Hash-Min labels and SSSP distances must be
bitwise equal (min combines are order-free); PageRank, a float sum, to
rtol=1e-5 with ``tol=0`` so that a round-off cannot flip the halt vote.
Every ``msgs_*``/``per_worker_*`` total must be equal integer for integer,
and ``n_supersteps`` equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import union_find_cc  # noqa: E402
from repro import api as rapi  # noqa: E402
from repro.graph import structs as rstructs  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from test_torch_graph import graph_pair, same_partition, to_np  # noqa: E402

CPU = "cpu"


def assert_totals_equal(sa, sb):
    assert set(sa) == set(sb)
    for k in sa:
        a, b = sa[k], sb[k]
        if isinstance(a, int):
            assert isinstance(b, int) and a == b, k
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=k)


def _run_both(algo, pg_ref, pg_t, cfg_kw, **params):
    ra = rapi.Engine(**cfg_kw).run(algo, pg_ref, **params)
    rb = tapi.Engine(device=CPU, **cfg_kw).run(algo, pg_t, **params)
    assert rb.n_supersteps == int(ra.n_supersteps)
    assert_totals_equal(ra.stats, rb.stats)
    return ra, rb


HASHMIN = [dict(backend=be, layout=lay, use_mirroring=mir)
           for be in ("dense", "pallas") for lay in ("padded", "csr")
           for mir in (True, False)]


@pytest.mark.parametrize("cfg", HASHMIN, ids=lambda c: "-".join(
    map(str, c.values())))
def test_hashmin_equal(cfg):
    g_ref, _ = graph_pair("powerlaw", 500, seed=21)
    pg_ref, pg_t = same_partition(g_ref, 6, tau=10, seed=3,
                                  layout=cfg["layout"])
    ra, rb = _run_both("hashmin", pg_ref, pg_t, cfg, record_history=True)
    assert rb.state.dtype == torch.int32
    np.testing.assert_array_equal(rb.state.numpy(), np.asarray(ra.state))
    for k in ra.history:
        np.testing.assert_array_equal(
            rb.history[k].numpy().astype(np.int64),
            np.asarray(ra.history[k]).astype(np.int64), err_msg=k)
    # and the port's labels are the connected components
    oc = union_find_cc(g_ref.n, g_ref.src, g_ref.dst)
    np.testing.assert_array_equal(
        tstructs.canonical_labels(pg_t, rb.state),
        rstructs.canonical_labels(pg_ref, ra.state))
    lab = rb.state.numpy().reshape(-1)[pg_t.perm]
    for comp in np.unique(oc):
        assert len(np.unique(lab[oc == comp])) == 1
    assert len(np.unique(lab)) == len(np.unique(oc))


@pytest.mark.parametrize("balance", ["edges", "edges+refine", "split",
                                     "vertex-cut"])
def test_hashmin_balance_modes_equal(balance):
    g_ref, _ = graph_pair("powerlaw", 500, seed=22)
    pg_ref, pg_t = same_partition(g_ref, 6, tau=10, seed=1, layout="csr",
                                  balance=balance, split_factor=1.0)
    cfg = dict(backend="pallas", layout="csr", balance=balance)
    ra, rb = _run_both("hashmin", pg_ref, pg_t, cfg)
    np.testing.assert_array_equal(rb.state.numpy(), np.asarray(ra.state))
    rep_a, rep_b = ra.load_report(), rb.load_report()
    assert rep_b["top_workers"] == rep_a["top_workers"]
    np.testing.assert_array_equal(rep_b["per_worker_total"],
                                  rep_a["per_worker_total"])


@pytest.mark.parametrize("backend,layout", [("dense", "padded"),
                                            ("pallas", "csr"),
                                            ("pallas", "padded")])
def test_pagerank_fixed_iterations_equal(backend, layout):
    g_ref, _ = graph_pair("powerlaw", 500, seed=23)
    pg_ref, pg_t = same_partition(g_ref, 6, tau=10, seed=2, layout=layout)
    cfg = dict(backend=backend, layout=layout)
    ra, rb = _run_both("pagerank", pg_ref, pg_t, cfg, n_iters=12, tol=0.0)
    assert rb.n_supersteps == 12
    assert rb.state.dtype == torch.float32
    np.testing.assert_allclose(rb.state.numpy(), np.asarray(ra.state),
                               rtol=1e-5, atol=1e-8)


def test_pagerank_default_tol_same_supersteps():
    g_ref, _ = graph_pair("powerlaw", 400, seed=24)
    pg_ref, pg_t = same_partition(g_ref, 4, tau=8, seed=0, layout="csr")
    ra, rb = _run_both("pagerank", pg_ref, pg_t,
                       dict(backend="pallas", layout="csr"), n_iters=60)
    assert rb.n_supersteps < 60
    np.testing.assert_allclose(rb.state.numpy(), np.asarray(ra.state),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("backend,layout,mirror", [
    ("pallas", "csr", True), ("dense", "padded", True),
    ("pallas", "padded", False)])
def test_sssp_equal(backend, layout, mirror):
    g_ref, _ = graph_pair("powerlaw", 500, seed=25, weighted=True)
    pg_ref, pg_t = same_partition(g_ref, 6, tau=9, seed=4, layout=layout)
    src = int(pg_ref.perm[0])
    cfg = dict(backend=backend, layout=layout, use_mirroring=mirror)
    ra, rb = _run_both("sssp", pg_ref, pg_t, cfg, source=src)
    np.testing.assert_array_equal(rb.state.numpy(), np.asarray(ra.state))
    assert np.isfinite(rb.state.numpy().reshape(-1)[src])


def test_engine_partitions_host_graphs_like_the_reference():
    g_ref, g_t = graph_pair("powerlaw", 300, seed=26)
    cfg = dict(backend="pallas", layout="csr", balance="edges")
    ra = rapi.Engine(**cfg).run("hashmin", g_ref, M=4, tau=8, seed=1)
    rb = tapi.Engine(device=CPU, **cfg).run("hashmin", g_t, M=4, tau=8,
                                            seed=1)
    np.testing.assert_array_equal(rb.state.numpy(), np.asarray(ra.state))
    assert_totals_equal(ra.stats, rb.stats)
    assert tapi.EngineConfig() == tapi.EngineConfig(
        **{f: getattr(rapi.EngineConfig(), f)
           for f in rapi.EngineConfig.__dataclass_fields__})


def test_what_this_slice_does_not_run_raises():
    with pytest.raises(NotImplementedError, match="sharded"):
        tapi.Engine(devices=2, device=CPU)
    with pytest.raises(NotImplementedError, match="pipeline"):
        tapi.Engine(pipeline=True, device=CPU)
    _, g_t = graph_pair("powerlaw", 100, seed=0)
    eng = tapi.Engine(device=CPU)
    for algo in ("sv", "msf", "attr_bcast", "gcn"):
        with pytest.raises(NotImplementedError, match="slice"):
            eng.run(algo, g_t, M=2)
    with pytest.raises(ValueError, match="unknown algo"):
        eng.run("bfs", g_t, M=2)
    pg = eng.partition(g_t, 2)
    from repro_torch.algorithms import hashmin
    with pytest.raises(NotImplementedError):
        hashmin.run(pg, tapi.EngineConfig(devices=4))


def test_bsp_totals_are_exact_int64():
    """Totals past 2^31 stay exact (int64 on the device, Python ints out)."""
    from repro_torch.core import bsp
    big = 2 ** 31 - 5

    def step(state, i):
        stats = {"msgs_x": torch.tensor(big, dtype=torch.int32),
                 "per_worker_x": torch.full((3,), big, dtype=torch.int32),
                 "float_x": torch.ones(())}
        return state + 1.0, state >= 7.0, stats

    _, stats, n, hist = bsp.run(step, torch.zeros(()), 100,
                                record_history=True)
    assert n == 8
    assert isinstance(stats["msgs_x"], int) and stats["msgs_x"] == 8 * big
    assert stats["per_worker_x"].dtype == np.int64
    np.testing.assert_array_equal(stats["per_worker_x"], np.full(3, 8 * big))
    assert float(stats["float_x"]) == 8.0
    assert hist["msgs_x"].shape == (100,)
    assert int(hist["msgs_x"][7]) == big and int(hist["msgs_x"][8]) == 0
    assert to_np(hist["per_worker_x"]).shape == (100, 3)
