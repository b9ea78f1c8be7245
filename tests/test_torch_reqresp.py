"""Port parity: the request-respond channel (Ch_req) and the runtime-target
scatters against the reference.

``rr_gather`` / ``rr_gather_flat`` on ``tests/test_reqresp.py``'s case (M=5
workers, 40 slots each, 60 requests a worker, 40% of them on one hot
target): values bitwise and every ``msgs_*`` / ``per_worker_*`` equal,
integer for integer, with and without dedup, scalar and F=3 payloads, and
a split partition's shard -> worker map.  Then Theorem 3's bound, the
dedup's idempotence, a worker whose requests are all masked (the
reference reads index -1 there, which JAX wraps and torch refuses), the
scatters for min/max/sum on int32 and float32 over both backends, the
mask-driven count of identity-valued writes, and ``node_embedding_fetch``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import channels as rch  # noqa: E402
from repro.models import embedding as remb  # noqa: E402
from repro_torch.core import channels as tch  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from test_torch_channels import assert_inbox, assert_stats  # noqa: E402
from test_torch_graph import graph_pair, same_partition, to_np  # noqa: E402

CASE_SEEDS = [0, 7, 123]


def _case(seed, M=5, n_loc=40, R=60, hot_frac=0.4, F=None):
    """tests/test_reqresp.py's request set: a hot target takes the first
    ``hot_frac`` of every worker's requests (the S-V skew pattern)."""
    rng = np.random.RandomState(seed)
    shape = (M, n_loc) if F is None else (M, n_loc, F)
    vals = rng.randn(*shape).astype(np.float32)
    targets = rng.randint(0, M * n_loc, (M, R)).astype(np.int32)
    hot = rng.randint(0, M * n_loc)
    targets[:, : int(R * hot_frac)] = hot
    mask = rng.rand(M, R) > 0.25
    return vals, targets, mask, M, n_loc, R


def _both(fn_ref, fn_t, *arrays, **kw):
    """Call the reference on jnp copies and the port on torch copies of
    the same numpy arrays."""
    a = fn_ref(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x
                 for x in arrays], **kw)
    b = fn_t(*[torch.from_numpy(x) if isinstance(x, np.ndarray) else x
               for x in arrays], **kw)
    return a, b


def _assert_gather(a, b):
    (out_a, sa), (out_b, sb) = a, b
    np.testing.assert_array_equal(to_np(out_b), to_np(out_a))
    assert out_b.dtype == torch.float32
    assert_stats(sa, sb)


@pytest.mark.parametrize("F", [None, 3])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("seed", CASE_SEEDS)
def test_rr_gather_equal(seed, dedup, F):
    vals, targets, mask, M, n_loc, R = _case(seed, F=F)
    _assert_gather(*_both(rch.rr_gather, tch.rr_gather, vals, targets, mask,
                          M, n_loc, dedup=dedup))


@pytest.mark.parametrize("F", [None, 3])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("seed", CASE_SEEDS)
def test_rr_gather_flat_equal(seed, dedup, F):
    vals, targets, mask, M, n_loc, R = _case(seed, F=F)
    worker = np.repeat(np.arange(M), R).astype(np.int32)
    a, b = _both(rch.rr_gather_flat, tch.rr_gather_flat, vals,
                 targets.reshape(-1), worker, mask.reshape(-1), M, n_loc,
                 dedup=dedup)
    _assert_gather(a, b)
    # and the flat stats equal the padded channel's on the same requests
    _, s_pad = tch.rr_gather(torch.from_numpy(vals),
                             torch.from_numpy(targets),
                             torch.from_numpy(mask), M, n_loc, dedup=dedup)
    assert_stats(s_pad, b[1])


@pytest.mark.parametrize("dedup", [True, False])
def test_rr_gather_flat_split_log_of_equal(dedup):
    """Physical shards dedup their own lists; ``log_of`` folds them back to
    logical workers for the remote test and the per-worker charges."""
    vals, targets, mask, M, n_loc, R = _case(5)
    log_of = np.array([0, 0, 1, 2, 2, 2, 3, 4], np.int64)
    rng = np.random.RandomState(1)
    worker = np.sort(rng.randint(0, len(log_of), M * R)).astype(np.int32)
    a, b = _both(rch.rr_gather_flat, tch.rr_gather_flat, vals,
                 targets.reshape(-1), worker, mask.reshape(-1), M, n_loc,
                 dedup=dedup, log_of=log_of)
    _assert_gather(a, b)


@pytest.mark.parametrize("layout,balance", [("padded", "hash"),
                                            ("csr", "hash"),
                                            ("csr", "split")])
def test_gather_edges_and_gather_equal(layout, balance):
    """The pg-level entry points on one partition: ``gather_edges`` (csr:
    the flat channel with the per-edge source worker, split: its shard
    ids) and ``gather`` of state-shaped pointer rows."""
    g_ref, _ = graph_pair("powerlaw", 300, seed=41)
    pg_ref, pg_t = same_partition(g_ref, 5, tau=8, seed=2, layout=layout,
                                  balance=balance, split_factor=1.0)
    if balance == "split":
        assert pg_t.phys_log is not None and pg_t.M_phys > pg_t.M
    attr = np.arange(pg_ref.n_pad, dtype=np.float32).reshape(
        pg_ref.M, pg_ref.n_loc) * 3
    a = rch.gather_edges(pg_ref, jnp.asarray(attr), pg_ref.all_dst,
                         pg_ref.all_mask)
    b = tch.gather_edges(pg_t, torch.from_numpy(attr), pg_t.all_dst,
                         pg_t.all_mask)
    _assert_gather(a, b)
    rng = np.random.RandomState(3)
    ptr = rng.randint(0, pg_ref.n_pad, (pg_ref.M, pg_ref.n_loc)
                      ).astype(np.int32)
    vm = np.asarray(pg_ref.vmask)
    a = rch.gather(pg_ref, jnp.asarray(attr), jnp.asarray(ptr),
                   jnp.asarray(vm))
    b = tch.gather(pg_t, torch.from_numpy(attr), torch.from_numpy(ptr),
                   pg_t.vmask)
    _assert_gather(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_thm3_bound_two_M_per_distinct_target(seed):
    """msgs_rr <= 2 * M * (#distinct requested targets), and the paper's
    per-target form 2 * sum_t min(M, l_t)."""
    vals, targets, mask, M, n_loc, R = _case(seed)
    _, stats = tch.rr_gather(torch.from_numpy(vals),
                             torch.from_numpy(targets),
                             torch.from_numpy(mask), M, n_loc)
    live = targets[mask]
    distinct = np.unique(live)
    assert int(stats["msgs_rr"]) <= 2 * M * len(distinct)
    bound = 2 * sum(min(M, int((live == t).sum())) for t in distinct)
    assert int(stats["msgs_rr"]) <= bound
    assert int(stats["msgs_rr"]) <= int(stats["msgs_basic"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dedup_row_idempotent_and_equal(seed):
    """Deduplicating an already-deduplicated list is a no-op, and both
    outputs equal the reference's, a (M, R) batch row for row."""
    rng = np.random.RandomState(seed)
    n_pad = 64
    t = rng.randint(0, n_pad + 1, 30).astype(np.int32)   # n_pad = masked
    u1, inv = tch._dedup_row(torch.from_numpy(t), n_pad)
    u2, _ = tch._dedup_row(u1, n_pad)
    np.testing.assert_array_equal(u2.numpy(), u1.numpy())
    ru, rinv = rch._dedup_row(jnp.asarray(t), n_pad)
    np.testing.assert_array_equal(u1.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(rinv))
    assert inv.dtype == torch.int32
    rows = rng.randint(0, n_pad + 1, (4, 30)).astype(np.int32)
    ub, ib = tch._dedup_row(torch.from_numpy(rows), n_pad)
    for r in range(4):
        ru, rinv = rch._dedup_row(jnp.asarray(rows[r]), n_pad)
        np.testing.assert_array_equal(ub[r].numpy(), np.asarray(ru))
        np.testing.assert_array_equal(ib[r].numpy(), np.asarray(rinv))


@pytest.mark.parametrize("F", [None, 3])
def test_row_with_every_request_masked(F):
    """A worker with no valid request: the reference's ``inv`` is -1 there
    (a wrapped read, masked to 0 afterwards); the port clamps before it
    reads and gives the same zeros and stats."""
    vals, targets, mask, M, n_loc, R = _case(9, F=F)
    mask[2] = False
    mask[4] = False
    _, inv = tch._dedup_row(torch.where(torch.from_numpy(mask),
                                        torch.from_numpy(targets),
                                        M * n_loc), M * n_loc)
    assert (inv[2] == -1).all() and (inv[4] == -1).all()
    a, b = _both(rch.rr_gather, tch.rr_gather, vals, targets, mask, M, n_loc)
    _assert_gather(a, b)
    assert not to_np(b[0])[[2, 4]].any()
    # every request of every worker masked
    a, b = _both(rch.rr_gather, tch.rr_gather, vals, targets,
                 np.zeros_like(mask), M, n_loc)
    _assert_gather(a, b)
    assert int(b[1]["msgs_rr"]) == 0


def _scatter_case(seed, dtype, M=5, n_loc=30, K=40):
    rng = np.random.RandomState(seed)
    targets = rng.randint(0, M * n_loc, (M, K)).astype(np.int32)
    targets[:, :8] = targets[0, 0]                      # a hot target
    mask = rng.rand(M, K) > 0.3
    if dtype == np.int32:
        base = rng.randint(-1000, 1000, (M, n_loc)).astype(np.int32)
        upd = rng.randint(-1000, 1000, (M, K)).astype(np.int32)
    else:
        base = rng.randn(M, n_loc).astype(np.float32)
        upd = rng.randn(M, K).astype(np.float32)
    return base, targets, upd, mask, M, n_loc, K


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_scatter_combine_equal(op, dtype, backend):
    base, targets, upd, mask, M, n_loc, _ = _scatter_case(11, dtype)
    (va, sa), (vb, sb) = _both(rch.scatter_combine, tch.scatter_combine,
                               base, targets, upd, mask, op, M, n_loc,
                               backend=backend)
    assert vb.dtype == torch.from_numpy(base).dtype
    assert_inbox(va, vb, op if dtype == np.float32 else "min")
    assert_stats(sa, sb)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_scatter_combine_flat_equal(op, dtype, backend):
    base, targets, upd, mask, M, n_loc, K = _scatter_case(12, dtype)
    worker = np.repeat(np.arange(M), K).astype(np.int32)
    (va, sa), (vb, sb) = _both(
        rch.scatter_combine_flat, tch.scatter_combine_flat, base,
        targets.reshape(-1), upd.reshape(-1), mask.reshape(-1), worker, op,
        M, n_loc, backend=backend)
    assert_inbox(va, vb, op if dtype == np.float32 else "min")
    assert_stats(sa, sb)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("op,ident_val", [("sum", 0.0),
                                          ("min", np.float32(np.inf))])
def test_identity_valued_writes_counted(op, ident_val, backend):
    """test_accounting.py's case through the scatters: every payload equals
    the combine identity, and each distinct (worker, remote target) pair
    with a real write still counts."""
    M, n_loc, K = 3, 8, 6
    rng = np.random.RandomState(0)
    targets = rng.randint(0, M * n_loc, (M, K)).astype(np.int32)
    mask = np.ones((M, K), bool)
    mask[1, 2] = False
    values = np.full((M, K), ident_val, np.float32)
    pairs = {(w, int(targets[w, k])) for w in range(M) for k in range(K)
             if mask[w, k]}
    want = sum(1 for w, t in pairs if t // n_loc != w)
    assert want > 0
    base = np.zeros((M, n_loc), np.float32)
    _, stats = tch.scatter_combine(
        torch.from_numpy(base), torch.from_numpy(targets),
        torch.from_numpy(values), torch.from_numpy(mask), op, M, n_loc,
        backend=backend)
    assert int(stats["msgs_combined"]) == want
    assert int(stats["per_worker_combined"].sum()) == want
    worker = np.repeat(np.arange(M), K).astype(np.int32)
    _, stats = tch.scatter_combine_flat(
        torch.from_numpy(base), torch.from_numpy(targets.reshape(-1)),
        torch.from_numpy(values.reshape(-1)),
        torch.from_numpy(mask.reshape(-1)), torch.from_numpy(worker), op, M,
        n_loc, backend=backend)
    assert int(stats["msgs_combined"]) == want


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_scatter_state_and_edges_equal(layout):
    """The pg-level scatters on one partition: state-shaped hooking writes
    and edge-shaped min-edge election (float32 weights)."""
    g_ref, _ = graph_pair("powerlaw", 300, seed=42, weighted=True)
    pg_ref, pg_t = same_partition(g_ref, 5, tau=8, seed=1, layout=layout)
    rng = np.random.RandomState(4)
    lab = rng.randint(0, pg_ref.n_pad, (pg_ref.M, pg_ref.n_loc)
                      ).astype(np.int32)
    vm = np.asarray(pg_ref.vmask)
    for backend in ("dense", "pallas"):
        a = rch.scatter_state(pg_ref, jnp.asarray(lab), jnp.asarray(lab),
                              jnp.asarray(lab // 2), jnp.asarray(vm), "min",
                              backend=backend)
        b = tch.scatter_state(pg_t, torch.from_numpy(lab),
                              torch.from_numpy(lab),
                              torch.from_numpy(lab // 2), pg_t.vmask, "min",
                              backend=backend)
        assert_inbox(a[0], b[0], "min")
        assert_stats(a[1], b[1])
        inf = np.full((pg_ref.M, pg_ref.n_loc), np.inf, np.float32)
        du_ref = pg_ref.edge_src_values(jnp.asarray(lab), pg_ref.all_src)
        du_t = pg_t.edge_src_values(torch.from_numpy(lab), pg_t.all_src)
        a = rch.scatter_edges(pg_ref, jnp.asarray(inf), du_ref,
                              pg_ref.all_w, pg_ref.all_mask, "min",
                              backend=backend)
        b = tch.scatter_edges(pg_t, torch.from_numpy(inf), du_t, pg_t.all_w,
                              pg_t.all_mask, "min", backend=backend)
        assert_inbox(a[0], b[0], "min")
        assert_stats(a[1], b[1])


def test_node_embedding_fetch_equal():
    """Ch_req with a vector (F,) payload: values bitwise, stats equal."""
    g_ref, _ = graph_pair("powerlaw", 300, seed=43)
    pg_ref, pg_t = same_partition(g_ref, 4, tau=8, seed=0, layout="csr")
    tab_r = remb.node_embedding_init(pg_ref, 8, seed=2)
    tab_t = temb.node_embedding_init(pg_t, 8, seed=2)
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_r))
    rng = np.random.RandomState(5)
    ids = rng.randint(0, pg_ref.n_pad, (pg_ref.M, 50)).astype(np.int32)
    ids[:, :20] = ids[0, 0]
    mask = rng.rand(pg_ref.M, 50) > 0.2
    a = remb.node_embedding_fetch(pg_ref, tab_r, jnp.asarray(ids),
                                  jnp.asarray(mask))
    b = temb.node_embedding_fetch(pg_t, tab_t, torch.from_numpy(ids),
                                  torch.from_numpy(mask))
    assert b[0].shape == (pg_t.M, 50, 8)
    _assert_gather(a, b)
