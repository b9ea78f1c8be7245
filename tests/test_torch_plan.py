"""Port parity: message plans (``core/plan.py``) against the reference.

The cases of ``tests/test_plan.py`` with the reference as the oracle:
``EdgePlan`` fields equal at equal ``nb``; ``combine_with_plan``,
``plan_seg_hits``, ``combine_rows_subset``, ``combine_sorted(_flat)`` and
``sort_by_worker_target`` equal (min/max and integers bitwise, float sums
to rtol=1e-6, every count exact).  Kernel modes of both packages are set
inside ``try``/``finally``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import plan as rplan  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from test_torch_graph import graph_pair, same_partition, to_np  # noqa: E402

PLAN_FIELDS = ("M_src", "M_dst", "n_loc", "nb", "eb", "B_per_w", "n_blocks",
               "n_segs", "n_rows", "row_gather", "row_valid", "row_local",
               "row_seg", "seg_blk", "seg_worker")


def _assert_values(a, b, op, dtype=np.float32):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape
    if op == "sum" and np.issubdtype(dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(a, b)


def _assert_counts(ref_stats, t_stats):
    for a, b in zip(ref_stats, t_stats):
        np.testing.assert_array_equal(to_np(b).astype(np.int64),
                                      to_np(a).astype(np.int64))


def _pgs(layout, balance="hash", tau=8):
    g_ref, _ = graph_pair("powerlaw", 500, seed=11, weighted=True)
    # split_factor=1.0 makes "split" cut every worker above the mean load
    return same_partition(g_ref, 6, tau=tau, seed=1, layout=layout,
                          balance=balance, split_factor=1.0)


@pytest.mark.parametrize("kind", ["eg", "all", "mir"])
@pytest.mark.parametrize("layout,balance", [("padded", "hash"),
                                            ("csr", "hash"),
                                            ("csr", "split")])
def test_edge_plan_fields_equal(layout, balance, kind):
    pg_ref, pg_t = _pgs(layout, balance)
    for nb, eb in [(32, None), (16, 8)]:
        pr = rplan.get_plan(pg_ref, kind, nb=nb, eb=eb)
        pt = tplan.get_plan(pg_t, kind, nb=nb, eb=eb)
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(pt, f), getattr(pr, f),
                                          err_msg=f)
        assert tplan.get_plan(pg_t, kind, nb=nb, eb=eb) is pt   # memoized


def test_default_nb_by_device():
    assert tplan.default_nb("cpu") == 32
    assert tplan.default_nb("cuda") == 128


def test_build_edge_plan_layout_equal():
    rng = np.random.RandomState(0)
    M, E, n_loc, nb, eb = 3, 40, 37, 8, 4
    dst = rng.randint(0, M * n_loc, (M, E))
    mask = rng.rand(M, E) > 0.3
    pr = rplan.build_edge_plan(dst // n_loc, dst % n_loc, mask, M, n_loc,
                               nb=nb, eb=eb)
    pt = tplan.build_edge_plan(dst // n_loc, dst % n_loc, mask, M, n_loc,
                               nb=nb, eb=eb)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pr, f))


def test_empty_plan():
    plan = tplan.build_edge_plan(np.zeros((2, 4), int),
                                 np.zeros((2, 4), int),
                                 np.zeros((2, 4), bool), 2, 10)
    inbox, (msgs, per) = tplan.combine_with_plan(
        plan, torch.zeros(8), "min", flat_hits=torch.zeros(8, dtype=bool))
    assert torch.isinf(inbox).all() and inbox.shape == (2, 10)
    assert int(msgs) == 0 and int(per.sum()) == 0


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_combine_with_plan_and_seg_hits_equal(layout, op, dtype):
    pg_ref, pg_t = _pgs(layout)
    pr = rplan.get_plan(pg_ref, "eg", nb=32)
    pt = tplan.get_plan(pg_t, "eg", nb=32)
    E = int(np.asarray(pg_ref.eg_mask).size)
    rng = np.random.RandomState(3)
    vals = (rng.randint(-50, 50, E).astype(np.int32) if dtype == "int32"
            else (rng.rand(E) + 0.5).astype(np.float32))
    hits = rng.rand(E) > 0.3
    ident = np.asarray(rplan.identity_of(op, jnp.dtype(dtype)))
    vals = np.where(hits, vals, ident).astype(dtype)
    inbox_r, st_r = rplan.combine_with_plan(pr, jnp.asarray(vals), op,
                                            flat_hits=jnp.asarray(hits))
    inbox_t, st_t = tplan.combine_with_plan(pt, torch.from_numpy(vals), op,
                                            flat_hits=torch.from_numpy(hits))
    assert inbox_t.dtype == getattr(torch, dtype)
    _assert_values(inbox_r, inbox_t, op, np.dtype(dtype))
    _assert_counts(st_r, st_t)
    np.testing.assert_array_equal(
        tplan.plan_seg_hits(pt, torch.from_numpy(hits)).numpy(),
        np.asarray(rplan.plan_seg_hits(pr, jnp.asarray(hits))))
    # pipeline chunks: a subset of rows combines as its slice of the whole
    rows = np.arange(0, pr.n_rows, 3)
    ok = rows % 2 == 0
    sub_r = rplan.combine_rows_subset(pr, jnp.asarray(vals),
                                      jnp.asarray(rows), jnp.asarray(ok), op)
    sub_t = tplan.combine_rows_subset(pt, torch.from_numpy(vals),
                                      torch.from_numpy(rows),
                                      torch.from_numpy(ok), op)
    _assert_values(sub_r, sub_t, op, np.dtype(dtype))


def test_split_plan_folds_stats_to_logical_workers():
    pg_ref, pg_t = _pgs("csr", "split", tau=None)
    assert pg_ref.phys_log is not None and pg_ref.M_phys > pg_ref.M
    pr = rplan.get_plan(pg_ref, "all", nb=32)
    pt = tplan.get_plan(pg_t, "all", nb=32)
    E = len(np.asarray(pg_ref.all_src))
    vals = np.random.RandomState(0).rand(E).astype(np.float32)
    hits = np.ones(E, bool)
    r = rplan.combine_with_plan(pr, jnp.asarray(vals), "min",
                                log_of=pg_ref.phys_log, M_out=pg_ref.M,
                                flat_hits=jnp.asarray(hits))
    t = tplan.combine_with_plan(pt, torch.from_numpy(vals), "min",
                                log_of=pg_t.phys_log, M_out=pg_t.M,
                                flat_hits=torch.from_numpy(hits))
    _assert_values(r[0], t[0], "min")
    _assert_counts(r[1], t[1])


def test_kernel_modes_agree():
    """Every kernel mode of both packages gives the same inbox (the
    reference's "pallas" mode runs the interpret-mode Pallas kernel)."""
    pg_ref, pg_t = _pgs("csr")
    pr = rplan.get_plan(pg_ref, "mir", nb=32)
    pt = tplan.get_plan(pg_t, "mir", nb=32)
    E = len(np.asarray(pg_ref.mir_esrc))
    vals = np.random.RandomState(5).rand(E).astype(np.float32)
    outs = []
    try:
        for rmode, tmode in [("ref", "ref"), ("pallas", "auto")]:
            rplan.set_kernel_mode(rmode)
            tplan.set_kernel_mode(tmode)
            a, _ = rplan.combine_with_plan(pr, jnp.asarray(vals), "max",
                                           count_cross=False)
            b, _ = tplan.combine_with_plan(pt, torch.from_numpy(vals), "max",
                                           count_cross=False)
            _assert_values(a, b, "max")
            outs.append(b)
    finally:
        rplan.set_kernel_mode("auto")
        tplan.set_kernel_mode("auto")
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def _runtime_targets(seed, M, n_loc, K):
    rng = np.random.RandomState(seed)
    targets = rng.randint(0, M * n_loc, (M, K)).astype(np.int32)
    targets[:, : K // 3] = targets[:, :1]         # duplicate targets
    values = rng.randn(M, K).astype(np.float32)
    mask = rng.rand(M, K) > 0.25
    return targets, values, mask


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_combine_sorted_equal(op):
    M, n_loc, K = 5, 40, 60
    targets, values, mask = _runtime_targets(2, M, n_loc, K)
    r = rplan.combine_sorted(jnp.asarray(targets), jnp.asarray(values),
                             jnp.asarray(mask), op, M, n_loc)
    t = tplan.combine_sorted(torch.from_numpy(targets),
                             torch.from_numpy(values),
                             torch.from_numpy(mask), op, M, n_loc)
    _assert_values(r[0], t[0], op)
    _assert_counts(r[1], t[1])
    seg_r = rplan.sorted_segments(jnp.asarray(targets), jnp.asarray(values),
                                  jnp.asarray(mask), op, M * n_loc)
    seg_t = tplan.sorted_segments(torch.from_numpy(targets),
                                  torch.from_numpy(values),
                                  torch.from_numpy(mask), op, M * n_loc)
    for a, b in zip(seg_r[:4], seg_t[:4]):
        _assert_values(a, b, op)


@pytest.mark.parametrize("op", ["min", "max", "sum"])
@pytest.mark.parametrize("split", [False, True])
def test_combine_sorted_flat_equal(op, split):
    M, n_loc, K = 4, 30, 50
    targets, values, mask = _runtime_targets(7, M, n_loc, K)
    worker = np.repeat(np.arange(M), K).astype(np.int32)
    log_of = None
    if split:       # worker 0 split into two physical shards
        worker = np.where((worker == 0) & (np.arange(M * K) % 2 == 1), M,
                          worker).astype(np.int32)
        log_of = np.append(np.arange(M), 0)
    args = (targets.reshape(-1), values.reshape(-1), mask.reshape(-1),
            worker)
    r = rplan.combine_sorted_flat(*map(jnp.asarray, args), op, M, n_loc,
                                  log_of=log_of)
    t = tplan.combine_sorted_flat(*map(torch.from_numpy, args), op, M,
                                  n_loc, log_of=log_of)
    _assert_values(r[0], t[0], op)
    _assert_counts(r[1], t[1])


def test_sort_by_worker_target_is_stable_and_equal():
    rng = np.random.RandomState(9)
    worker = rng.randint(0, 4, 300).astype(np.int32)
    t = rng.randint(0, 20, 300).astype(np.int32)       # many ties
    r = rplan.sort_by_worker_target(jnp.asarray(worker), jnp.asarray(t))
    p = tplan.sort_by_worker_target(torch.from_numpy(worker),
                                    torch.from_numpy(t))
    for a, b in zip(r, p):
        np.testing.assert_array_equal(to_np(b), to_np(a))
