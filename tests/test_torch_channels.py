"""Port parity: the broadcast channels (Ch_msg + Ch_mir) against the
reference.

``push_combined(_flat)``, ``push_mirror`` and ``broadcast`` over both
backends, both layouts and mirroring on/off.  Inboxes: bitwise for
min/max, rtol=1e-6 for sum (the combine order differs).  Every
``msgs_*`` and ``per_worker_*`` must be equal, integer for integer.  The
accounting rule the port most easily gets wrong has its own test: a
destination counts when a message was sent, whatever its payload.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channels as rch  # noqa: E402
from repro_torch.core import channels as tch  # noqa: E402
from test_torch_graph import graph_pair, same_partition, to_np  # noqa: E402

B24 = 16_777_216


def assert_inbox(a, b, op):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape
    if op == "sum":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
    else:
        np.testing.assert_array_equal(b, a)


def assert_stats(sa, sb):
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(to_np(sb[k]).astype(np.int64),
                                      to_np(sa[k]).astype(np.int64),
                                      err_msg=k)


def _runtime(seed, M, n_loc, K):
    rng = np.random.RandomState(seed)
    targets = rng.randint(0, M * n_loc, (M, K)).astype(np.int32)
    values = rng.randn(M, K).astype(np.float32)
    mask = rng.rand(M, K) > 0.3
    return targets, values, mask


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_push_combined_equal(op, backend):
    M, n_loc, K = 5, 30, 40
    targets, values, mask = _runtime(4, M, n_loc, K)
    a = rch.push_combined(jnp.asarray(targets), jnp.asarray(values),
                          jnp.asarray(mask), op, M, n_loc, backend=backend)
    b = tch.push_combined(torch.from_numpy(targets),
                          torch.from_numpy(values), torch.from_numpy(mask),
                          op, M, n_loc, backend=backend)
    assert_inbox(a[0], b[0], op)
    assert_stats(a[1], b[1])


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_push_combined_flat_equal(op, backend):
    M, n_loc, K = 4, 25, 30
    targets, values, mask = _runtime(8, M, n_loc, K)
    worker = np.repeat(np.arange(M), K).astype(np.int32)
    args = (targets.reshape(-1), values.reshape(-1), mask.reshape(-1),
            worker)
    a = rch.push_combined_flat(*map(jnp.asarray, args), op, M, n_loc,
                               backend=backend)
    b = tch.push_combined_flat(*map(torch.from_numpy, args), op, M, n_loc,
                               backend=backend)
    assert_inbox(a[0], b[0], op)
    assert_stats(a[1], b[1])


CASES = [(layout, balance) for layout in ("padded", "csr")
         for balance in ("hash", "vertex-cut")] + [("csr", "split")]


@pytest.mark.parametrize("layout,balance", CASES)
@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_broadcast_equal(layout, balance, backend):
    g_ref, _ = graph_pair("powerlaw", 400, seed=13, weighted=True)
    pg_ref, pg_t = same_partition(g_ref, 6, tau=9, seed=2, layout=layout,
                                  balance=balance, split_factor=1.0)
    rng = np.random.RandomState(1)
    shape = (pg_ref.M, pg_ref.n_loc)
    vmask = np.asarray(pg_ref.vmask)
    active = (rng.rand(*shape) > 0.2) & vmask
    fvals = (rng.rand(*shape) + 0.5).astype(np.float32)
    ivals = rng.randint(0, 1000, shape).astype(np.int32)
    # (op, values, relay, use_mirroring)
    cases = [("min", fvals, "none", True), ("max", fvals, "none", False),
             ("sum", fvals, "none", True), ("sum", fvals, "mul_w", False),
             ("min", fvals, "add_w", True), ("min", fvals, "add_w", False),
             ("min", ivals, "none", True)]
    for op, vals, relay, mirror in cases:
        # one jit per case compiles faster than the reference's eager ops
        a = jax.jit(lambda v, act: rch.broadcast(
            pg_ref, v, act, op, relay=relay, use_mirroring=mirror,
            backend=backend))(jnp.asarray(vals), jnp.asarray(active))
        b = tch.broadcast(pg_t, torch.from_numpy(vals),
                          torch.from_numpy(active), op, relay=relay,
                          use_mirroring=mirror, backend=backend)
        assert b[0].dtype == torch.from_numpy(vals).dtype
        assert_inbox(a[0], b[0], op)
        assert_stats(a[1], b[1])


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_push_mirror_equal(layout, backend):
    g_ref, _ = graph_pair("powerlaw", 500, seed=3, weighted=True)
    pg_ref, pg_t = same_partition(g_ref, 4, tau=7, seed=0, layout=layout)
    assert int((np.asarray(pg_ref.mir_ids) < pg_ref.n_pad).sum()) > 0
    vals = np.random.RandomState(2).rand(pg_ref.M, pg_ref.n_loc
                                         ).astype(np.float32)
    act = np.array(pg_ref.vmask)
    a = rch.push_mirror(pg_ref, jnp.asarray(vals), jnp.asarray(act), "min",
                        relay="add_w", backend=backend)
    b = tch.push_mirror(pg_t, torch.from_numpy(vals), torch.from_numpy(act),
                        "min", relay="add_w", backend=backend)
    assert_inbox(a[0], b[0], "min")
    assert_stats(a[1], b[1])


def _expected_pairs(targets, mask, n_loc):
    pairs = {(w, int(targets[w, k])) for w in range(targets.shape[0])
             for k in range(targets.shape[1]) if mask[w, k]}
    return sum(1 for w, t in pairs if t // n_loc != w)


@pytest.mark.parametrize("op,ident_val", [("sum", 0.0),
                                          ("min", np.float32(np.inf))])
def test_identity_valued_messages_counted(op, ident_val):
    """A message whose payload equals the combine identity (a PageRank
    contribution of exactly 0.0, +inf under min) is still a message: every
    combine path counts by the send mask, never by the combined value."""
    M, n_loc, K = 3, 8, 6
    rng = np.random.RandomState(0)
    targets = rng.randint(0, M * n_loc, (M, K)).astype(np.int32)
    mask = np.ones((M, K), bool)
    mask[1, 2] = False
    values = np.full((M, K), ident_val, np.float32)
    want = _expected_pairs(targets, mask, n_loc)
    assert want > 0
    worker = np.repeat(np.arange(M), K).astype(np.int32)
    for backend in ("dense", "pallas"):
        _, s = tch.push_combined(torch.from_numpy(targets),
                                 torch.from_numpy(values),
                                 torch.from_numpy(mask), op, M, n_loc,
                                 backend=backend)
        assert int(s["msgs_combined"]) == want, backend
        assert int(s["per_worker_combined"].sum()) == want
        _, s = tch.push_combined_flat(
            torch.from_numpy(targets.reshape(-1)),
            torch.from_numpy(values.reshape(-1)),
            torch.from_numpy(mask.reshape(-1)), torch.from_numpy(worker),
            op, M, n_loc, backend=backend)
        assert int(s["msgs_combined"]) == want, f"flat/{backend}"


def test_identity_payload_invariant_broadcast():
    """Broadcasting all-zero values under sum reports exactly the stats of
    broadcasting nonzero values with the same activity, on the plan/kernel
    path too."""
    g_ref, _ = graph_pair("powerlaw", 300, seed=2, weighted=True)
    for layout in ("padded", "csr"):
        _, pg = same_partition(g_ref, 4, tau=8, seed=0, layout=layout)
        ones = torch.ones(pg.M, pg.n_loc)
        zeros = torch.zeros(pg.M, pg.n_loc)
        for backend in ("dense", "pallas"):
            _, s1 = tch.broadcast(pg, ones, pg.vmask, "sum", backend=backend)
            _, s0 = tch.broadcast(pg, zeros, pg.vmask, "sum",
                                  backend=backend)
            assert int(s1["msgs_combined"]) > 0
            assert_stats(s1, s0)


def test_min_combine_int_exact_small():
    """The 2^24 miniature: the int32 min-combine keeps adjacent ids above
    2^24 exact on every backend (float32 cannot hold 2^24 + 1)."""
    M, n_loc = 2, 2
    targets = torch.tensor([[0], [0]], dtype=torch.int32)
    values = torch.tensor([[B24 + 2], [B24 + 1]], dtype=torch.int32)
    mask = torch.tensor([[True], [True]])
    for backend in ("dense", "pallas"):
        inbox, _ = tch.push_combined(targets, values, mask, "min", M, n_loc,
                                     backend=backend)
        assert inbox.dtype == torch.int32
        assert int(inbox[0, 0]) == B24 + 1, backend
    assert int(torch.tensor(B24 + 1, dtype=torch.float32)) == B24


def test_unknown_backend_and_relay_raise():
    t = torch.zeros((2, 3), dtype=torch.int32)
    v = torch.zeros((2, 3))
    m = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="backend"):
        tch.push_combined(t, v, m, "min", 2, 3, backend="xla")
    with pytest.raises(ValueError, match="relay"):
        tch.relay_values(v, v, "pow_w")
    # one trailing feature axis at most (vector payloads are (M, K, F))
    with pytest.raises(ValueError, match="feature axis"):
        tch.push_combined(t, v[..., None, None], m, "min", 2, 3)
