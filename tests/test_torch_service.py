"""Port parity: the resident graph service against the JAX package's.

* ``EdgeDelta.symmetrized``, ``apply_delta`` and ``fold_delta`` equal the
  reference's array for array (values and dtypes) over its (layout,
  balance) parametrization, add-only and remove-only deltas included, and
  the no-mirror fold keeps Ch_msg and the full adjacency one set of
  tensors.
* ``shard_profile`` gives the reference's envelope and ``reshard_arrays``
  its padded tables; ``shard(..., profile=)`` pads a rank's tables to
  them, and ``reshard`` refills them in place (same storage) or raises
  ``ProfileOverflow`` and leaves them.
* ``GraphService`` on a gloo group of world size 1 gives the reference
  service's answers, epochs, ``cached`` flags, supersteps and ``msgs_*``
  statistics on the same graph, seed and queries, before and after
  folds, an elastic repartition and a profile overflow; its executor
  counter stays flat across batches and folds (and the tables' storage
  with it) and grows on an overflow; it refuses what the reference
  refuses.

The launcher's own test (``serve_graph`` in a process of its own) is in
``test_torch_service_cli.py``, so that the two files take about as long
under the suite's one-file-a-worker scheduling.

Tolerances: SSSP distances, ego answers and every statistic bitwise; PPR
within 1e-6 of its max (float32 sums in another order; on these inputs
the two packages agree bitwise); the oracles' own tolerances as in the
reference's tests (SSSP allclose, PPR atol 1e-5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from conftest import union_find_cc  # noqa: E402
from repro.api import EngineConfig as REngineConfig  # noqa: E402
from repro.core import exec as rexec  # noqa: E402
from repro.core import service as rservice  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph import structs as rstructs  # noqa: E402
from repro_torch.api import EngineConfig  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.core import service as tservice  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from test_service import (ARRAY_FIELDS, _ppr_oracle,  # noqa: E402
                          churn_delta)

PPR_RTOL = 1e-6
OFFSETS = ("eg_off", "all_off", "mir_eoff", "pair_counts", "phys_log",
           "phys_eg_off", "phys_all_off", "phys_mir_off")
SVC = dict(M=4, buckets=(2, 4), ppr_iters=8, max_supersteps=64,
           profile_slack=2.0)


def tgraph(g) -> tstructs.Graph:
    return tstructs.Graph(g.n, g.src, g.dst, g.weight)


def tdelta(d) -> tstructs.EdgeDelta:
    return tstructs.EdgeDelta(d.add_src, d.add_dst, d.add_w, d.rem_src,
                              d.rem_dst)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def assert_same_fold(want, got):
    for f in ARRAY_FIELDS + OFFSETS:
        a, b = getattr(want, f), _np(getattr(got, f))
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        a = np.asarray(a)
        assert a.shape == b.shape and (a.dtype == b.dtype or f in (
            "perm", "pair_counts")), (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (want.M, want.n_loc, want.tau, want.layout, want.balance,
            want.M_phys) == (got.M, got.n_loc, got.tau, got.layout,
                             got.balance, got.M_phys)


def both_partitions(g, M, **kw):
    return (rstructs.partition(g, M, **kw),
            tstructs.partition(tgraph(g), M, device="cpu", **kw))


# -- deltas and folds ----------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_edge_delta_and_apply_delta_equal(weighted):
    g = rgen.powerlaw(200, avg_deg=5, seed=4, weighted=weighted
                      ).symmetrized()
    d = churn_delta(g, 0.05, 9, symmetric=False)
    for a, b in ((d, tdelta(d)), (d.symmetrized(), tdelta(d).symmetrized())):
        for f in ("add_src", "add_dst", "add_w", "rem_src", "rem_dst"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(y, x, err_msg=f)
        ga, gb = rstructs.apply_delta(g, a), tstructs.apply_delta(tgraph(g), b)
        for f in ("src", "dst", "weight"):
            x, y = getattr(ga, f), getattr(gb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(y, x, err_msg=f)


@pytest.mark.parametrize("layout,balance", [
    ("csr", "hash"), ("csr", "edges"), ("csr", "edges+refine"),
    ("csr", "split"), ("csr", "vertex-cut"), ("padded", "hash")])
def test_fold_equals_the_reference_fold(layout, balance):
    for seed in range(3):
        g = rgen.powerlaw(300, avg_deg=5, seed=seed,
                          weighted=True).symmetrized()
        ra, ta = both_partitions(g, 8, tau=8, seed=seed, layout=layout,
                                 balance=balance, split_factor=1.1)
        delta = churn_delta(g, 0.05, seed + 100)
        folded = tstructs.fold_delta(ta, tdelta(delta))
        assert_same_fold(rstructs.fold_delta(ra, delta), folded)
        # and the fold is a partition under the pinned perm
        fresh = tstructs.partition(tstructs.apply_delta(tgraph(g),
                                                        tdelta(delta)),
                                   8, tau=ta.tau, layout=layout,
                                   balance=balance, split_factor=1.1,
                                   perm=ta.perm, device="cpu")
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(_np(getattr(folded, f)),
                                          _np(getattr(fresh, f)), f)


def test_fold_no_mirror_fast_path_equal():
    for seed in range(3):
        g = rgen.powerlaw(280, avg_deg=5, seed=seed,
                          weighted=True).symmetrized()
        ra, ta = both_partitions(g, 8, layout="csr", balance="edges")
        delta = churn_delta(g, 0.05, seed + 50)
        folded = tstructs.fold_delta(ta, tdelta(delta))
        assert_same_fold(rstructs.fold_delta(ra, delta), folded)
        assert folded.eg_src is folded.all_src
        assert folded.host["eg_w"] is folded.host["all_w"]


@pytest.mark.parametrize("kind", ["add", "remove"])
def test_fold_add_only_and_remove_only_equal(kind):
    g = rgen.powerlaw(240, avg_deg=4, seed=2, weighted=True).symmetrized()
    ra, ta = both_partitions(g, 4, tau=6, seed=0, layout="csr",
                             balance="edges")
    rng = np.random.RandomState(0)
    if kind == "add":
        d = rstructs.EdgeDelta(add_src=rng.randint(0, g.n, 40),
                               add_dst=rng.randint(1, g.n, 40),
                               add_w=rng.rand(40).astype(np.float32)
                               ).symmetrized()
    else:
        rems = churn_delta(g, 0.03, 5)
        d = rstructs.EdgeDelta(rem_src=rems.rem_src, rem_dst=rems.rem_dst)
    assert_same_fold(rstructs.fold_delta(ra, d),
                     tstructs.fold_delta(ta, tdelta(d)))


# -- shard profiles --------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("tau", [None, 6])
def test_shard_profile_and_reshard_arrays_equal(D, tau):
    g = rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()
    ra, ta = both_partitions(g, 8, tau=tau, seed=1, layout="csr",
                             balance="edges")
    want = rexec.shard_profile(ra, D, slack=1.5)
    got = texec.shard_profile(ta, D, slack=1.5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    delta = churn_delta(g, 0.03, 11)
    fa = rexec.reshard_arrays(rstructs.fold_delta(ra, delta), D, want)
    fb = texec.reshard_arrays(tstructs.fold_delta(ta, tdelta(delta)), D,
                              got)
    for k, a in fa.items():
        a = np.asarray(a)
        assert fb[k].shape == a.shape, k
        np.testing.assert_array_equal(fb[k], a, err_msg=k)


def test_profile_refuses_what_the_reference_refuses():
    g = rgen.powerlaw(120, avg_deg=4, seed=0, weighted=True).symmetrized()
    for kw in (dict(layout="padded"), dict(layout="csr", balance="split")):
        _, ta = both_partitions(g, 4, **kw)
        with pytest.raises(ValueError):
            texec.shard_profile(ta, 2)
    _, ta = both_partitions(g, 4, layout="csr")
    with pytest.raises(ValueError, match="1-D"):
        texec.shard_profile(ta, (1, 2))


def test_service_needs_a_process_group():
    assert not dist.is_initialized()
    g = tstructs.Graph(16, np.arange(15), np.arange(1, 16), None)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tservice.GraphService(g, M=4, device="cpu")


@pytest.fixture(scope="module")
def group():
    """A gloo group of world size 1 in this process (the service runs on
    the sharded executor), destroyed with the module."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(),
                                world_size=1, rank=0)
    yield
    if own:
        meshlib.destroy()


def test_shard_under_a_profile_and_reshard_in_place(group):
    g = rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()
    _, ta = both_partitions(g, 4, tau=6, seed=1, layout="csr",
                            balance="edges")
    prof = texec.shard_profile(ta, 1, slack=1.5)
    sg = texec.shard(ta, 1, device="cpu", profile=prof)
    host = texec.reshard_arrays(ta, 1, prof)
    assert tuple(sg.eg_src.shape) == (prof.eg_cap,) == host["eg_src"][0].shape
    assert tuple(sg.mir_ids.shape) == (prof.n_mir,)
    assert sg.fetch["mir"].send_slot.shape[-1] == prof.fetch_cap
    assert sg.fetch["mir"].n_need == prof.fetch_need
    before = {k: (t.data_ptr(), t.clone()) for k, t in texec._tensors(sg)}
    folded = tstructs.fold_delta(ta, tdelta(churn_delta(g, 0.05, 3)))
    texec.reshard(sg, folded, prof)
    fresh = texec.shard(folded, 1, device="cpu", profile=prof)
    changed = 0
    for k, t in texec._tensors(sg):
        assert t.data_ptr() == before[k][0], k
        assert torch.equal(t, dict(texec._tensors(fresh))[k]), k
        changed += not torch.equal(t, before[k][1])
    assert changed > 0
    # a graph that outgrows the envelope raises and leaves the tables
    rng = np.random.RandomState(0)
    big = tstructs.EdgeDelta(add_src=rng.randint(0, g.n, g.m),
                             add_dst=rng.randint(0, g.n, g.m))
    kept = {k: t.clone() for k, t in texec._tensors(sg)}
    with pytest.raises(texec.ProfileOverflow):
        texec.reshard(sg, tstructs.fold_delta(folded, big), prof)
    for k, t in texec._tensors(sg):
        assert torch.equal(t, kept[k]), k


# -- the service against the reference's ---------------------------------------

def make_pair(g, **kw):
    """(reference service, port service) on the same graph, warmed."""
    opts = dict(SVC, **kw)
    ref = rservice.GraphService(
        g, config=REngineConfig(layout="csr", balance="edges", devices=1),
        **opts)
    port = tservice.GraphService(
        tgraph(g), config=EngineConfig(layout="csr", balance="edges",
                                       devices=1), device="cpu", **opts)
    ref.warmup()
    port.warmup()
    return ref, port


def request(pair, queries):
    ref, port = pair
    a = rservice.GraphClient(ref).request(
        [rservice.Query(k, s) for k, s in queries])
    b = tservice.GraphClient(port).request(
        [tservice.Query(k, s) for k, s in queries])
    return a, b


def assert_same_answers(pair, a, b):
    ref, port = pair
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.query.kind, x.query.source) == (y.query.kind, y.query.source)
        assert (x.epoch, x.cached) == (y.epoch, y.cached), x.query
        if x.query.kind == "ppr":
            scale = max(float(np.abs(x.value).max()), 1e-30)
            assert float(np.abs(y.value - x.value).max()) <= PPR_RTOL * scale
        elif x.query.kind == "sssp":
            assert y.value.dtype == x.value.dtype
            np.testing.assert_array_equal(y.value, x.value)
        else:
            assert y.value == x.value
    assert port.epoch == ref.epoch
    assert ref.last_pump == port.last_pump
    for k in ("bucket", "epoch", "lanes_sssp", "lanes_ppr", "n_supersteps"):
        assert port.last_batch.get(k) == ref.last_batch.get(k), k
    rs, ts = ref.last_batch.get("stats", {}), port.last_batch.get("stats", {})
    assert sorted(rs) == sorted(ts)
    for k, v in rs.items():
        np.testing.assert_array_equal(np.asarray(ts[k]), np.asarray(v),
                                      err_msg=k)


@pytest.fixture(scope="module")
def pair(group):
    g = rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()
    return make_pair(g)


MIXED = [("sssp", 0), ("sssp", 11), ("ppr", 7), ("ego", 5), ("ppr", 7),
         ("sssp", 0), ("ego", 200), ("ppr", 150)]


def test_mixed_batch_matches_the_reference_and_oracles(pair):
    a, b = request(pair, MIXED)
    assert_same_answers(pair, a, b)
    ref, port = pair
    assert port.traces == ref.traces == len(port.buckets) + 1
    g = port.snapshot_graph()
    want = _ppr_oracle(g, 7, port.ppr_alpha, port.ppr_iters)
    assert np.allclose(b[2].value, want, atol=1e-5)
    roots = union_find_cc(g.n, g.src, g.dst)
    sizes = np.bincount(roots, minlength=g.n)
    assert b[3].value == (int(roots[5]), int(sizes[roots[5]]))


def test_result_cache_and_coalescing(pair):
    ref, port = pair
    a, b = request(pair, [("sssp", 21)])
    assert not b[0].cached
    a2, b2 = request(pair, [("sssp", 21)])
    assert b2[0].cached and np.array_equal(b[0].value, b2[0].value)
    assert_same_answers(pair, a2, b2)
    a, b = request(pair, [("ppr", 33), ("ppr", 33)])
    assert port.last_pump["lanes_ppr"] == 1
    assert np.array_equal(b[0].value, b[1].value)
    assert_same_answers(pair, a, b)


def test_epoch_barrier_and_folds_match_the_reference(pair):
    ref, port = pair
    g0 = ref.snapshot_graph()
    e0 = port.epoch
    traces = port.traces
    ptrs = {k: t.data_ptr() for k, t in texec._tensors(port.sg)}
    d1, d2 = churn_delta(g0, 0.05, 42), churn_delta(g0, 0.02, 43)
    got = []
    for svc, mod, conv in ((ref, rservice, lambda d: d),
                           (port, tservice, tdelta)):
        svc.mutate(conv(d1))
        t_a = svc.submit([mod.Query("sssp", 17)])
        svc.mutate(conv(d2))
        t_b = svc.submit([mod.Query("ppr", 9), mod.Query("ego", 17)])
        svc.pump()
        got.append([svc.take_result(t) for t in t_a + t_b])
    assert_same_answers(pair, *got)
    assert all(r.epoch == e0 + 1 for r in got[1])
    assert port.epoch == e0 + 1      # both folds collapsed into one barrier
    assert port.traces == traces
    assert ptrs == {k: t.data_ptr() for k, t in texec._tensors(port.sg)}
    for k in ARRAY_FIELDS + OFFSETS:
        a, b = getattr(ref.pg, k), _np(getattr(port.pg, k))
        if a is not None:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=k)
    a, b = request(pair, MIXED)
    assert_same_answers(pair, a, b)


def test_counter_flat_and_storage_kept_across_batches_and_folds(pair):
    ref, port = pair
    traces = port.traces
    ptrs = {k: t.data_ptr() for k, t in texec._tensors(port.sg)}
    a, b = request(pair, [("sssp", 40), ("ppr", 41), ("ego", 42)])
    assert_same_answers(pair, a, b)
    d = churn_delta(ref.snapshot_graph(), 0.03, 77)
    ref.mutate(d)
    port.mutate(tdelta(d))
    a, b = request(pair, [("sssp", 43), ("ppr", 44), ("ego", 45)])
    assert_same_answers(pair, a, b)
    assert port.traces == traces == ref.traces
    assert ptrs == {k: t.data_ptr() for k, t in texec._tensors(port.sg)}


def test_elastic_repartition_matches_the_reference(group):
    g = rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()
    pr = make_pair(g, buckets=(2,), ppr_iters=6, rebalance_threshold=1.0)
    ref, port = pr
    a, b = request(pr, [("sssp", 0), ("ppr", 7)])
    assert_same_answers(pr, a, b)
    assert port.repartitions == ref.repartitions >= 1
    traces = port.traces
    d = churn_delta(ref.snapshot_graph(), 0.05, 21)
    ref.mutate(d)
    port.mutate(tdelta(d))
    a, b = request(pr, [("sssp", 12), ("ppr", 29), ("ego", 4)])
    assert_same_answers(pr, a, b)
    assert port.repartitions == ref.repartitions
    assert port.traces == traces
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(_np(getattr(port.pg, k)),
                                      np.asarray(getattr(ref.pg, k)), k)


def test_mirrored_service_matches_the_reference(group):
    """tau=6: mirrored vertices, so the padded mirror tables and the
    mirror fetch plan of the profile are in play, before and after a
    fold."""
    g = rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()
    pr = make_pair(g, tau=6)
    ref, port = pr
    assert int((port.sg.mir_ids < port.pg.n_pad).sum()) > 0
    a, b = request(pr, MIXED)
    assert_same_answers(pr, a, b)
    d = churn_delta(g, 0.05, 8)
    ref.mutate(d)
    port.mutate(tdelta(d))
    a, b = request(pr, MIXED)
    assert_same_answers(pr, a, b)
    assert port.traces == ref.traces == len(port.buckets) + 1


def test_rebalance_threshold_gates_the_trigger(group):
    g = rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()
    port = tservice.GraphService(
        tgraph(g), config=EngineConfig(layout="csr", balance="edges",
                                       devices=1), device="cpu",
        **dict(SVC, buckets=(2,), ppr_iters=6, rebalance_threshold=1e9))
    port.warmup()
    tservice.GraphClient(port).request([tservice.Query("sssp", 0),
                                        tservice.Query("ppr", 7)])
    assert port.repartitions == 0
    assert port.last_batch["stats"]["per_worker_total"].size == port.M
    port.repartition()
    assert port.repartitions == 1


def test_repartition_retightens_pair_counts(group):
    g = rgen.powerlaw(300, avg_deg=5, seed=3, weighted=True).symmetrized()
    port = tservice.GraphService(
        tgraph(g), config=EngineConfig(layout="csr", balance="edges",
                                       devices=1), device="cpu",
        **dict(SVC, buckets=(2,), ppr_iters=6))
    port.mutate(tdelta(churn_delta(g, 0.08, 11)))
    port.pump()
    fresh = port.engine.partition(port.g, port.M, tau=port.tau,
                                  seed=port.seed)
    assert np.all(port.pg.pair_counts >= fresh.pair_counts)
    assert np.any(port.pg.pair_counts > fresh.pair_counts)
    port.repartition()
    np.testing.assert_array_equal(port.pg.pair_counts, fresh.pair_counts)


def test_profile_overflow_rewarms_and_matches_the_reference(group):
    g = rgen.powerlaw(200, avg_deg=4, seed=5, weighted=True).symmetrized()
    pr = make_pair(g, buckets=(2,), ppr_iters=6, profile_slack=1.01)
    ref, port = pr
    traces = port.traces
    rng = np.random.RandomState(9)
    k = g.m      # double the edge count: guaranteed to blow the envelope
    a_s = rng.randint(0, g.n, size=k)
    a_d = rng.randint(1, g.n, size=k)
    keep = a_s != a_d
    d = rstructs.EdgeDelta(
        add_src=a_s[keep], add_dst=a_d[keep],
        add_w=rng.rand(int(keep.sum())).astype(np.float32) + 0.01
    ).symmetrized()
    old = port.profile
    ref.mutate(d)
    port.mutate(tdelta(d))
    a, b = request(pr, [("sssp", 3), ("ppr", 8), ("ego", 3)])
    assert_same_answers(pr, a, b)
    assert b[0].epoch == 1
    assert port.profile != old and port.profile == texec.shard_profile(
        port.pg, 1, slack=1.01)
    # the bucket's executor and the component program are built again
    assert port.traces == traces + 2


def test_service_refuses_what_the_reference_refuses(group):
    g = tstructs.Graph(16, np.arange(15), np.arange(1, 16), None)
    for cfg in (EngineConfig(layout="padded", devices=1),
                EngineConfig(layout="csr", backend="pallas", devices=1),
                EngineConfig(layout="csr", balance="split", devices=1)):
        with pytest.raises(ValueError):
            tservice.GraphService(g, M=4, config=cfg, device="cpu")
    with pytest.raises(RuntimeError, match="world size"):
        tservice.GraphService(g, M=4, config=EngineConfig(
            layout="csr", devices=2), device="cpu")
    svc = tservice.GraphService(g, M=4, config=EngineConfig(
        layout="csr", devices=1), device="cpu")
    with pytest.raises(ValueError):
        svc.submit([tservice.Query("nope", 0)])
    with pytest.raises(ValueError):
        svc.submit([tservice.Query("sssp", 99)])
