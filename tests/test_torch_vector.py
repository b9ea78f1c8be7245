"""Port parity: feature-blocked (lanes, F) payloads against the reference.

The single-device cases of ``tests/test_vector_payloads.py`` (the Ch_req
``gather`` and ``node_embedding_fetch`` cases wait for that slice), plus the
plan and channel entry points the vector join runs through.  The reference
runs its Pallas kernel in interpret mode or its plain ``ref.py``; the port
runs its plain version (the CPU path).  Tolerances:

* integers, min and max: bitwise;
* float32 sums: rtol=1e-5 against the reference (the port merges plan rows
  straight into blocks, the reference through segments, and the
  reference's own vector sum differs from per-feature scalar sums: its red
  test ``test_vector_blocks_match_per_feature_scalar[sum]``);
* half-precision sums: the reference's own 2e-2;
* message stats: exact, and equal to the scalar broadcast's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import channels as rch  # noqa: E402
from repro.core import plan as rplan  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.kernels.segment_combine import ops as ref_ops  # noqa: E402
from repro.kernels.segment_combine.kernel import (  # noqa: E402
    segment_combine_blocks as pallas_blocks)
from repro.kernels.segment_combine.ref import (  # noqa: E402
    segment_combine_blocks_ref as jnp_blocks)
from repro_torch.core import channels as tch  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels.segment_combine import kernel as tkernel  # noqa: E402
from repro_torch.kernels.segment_combine import ops as tops  # noqa: E402
from repro_torch.kernels.segment_combine.ref import (  # noqa: E402
    segment_combine_blocks_ref as torch_blocks)
from test_torch_graph import same_partition, to_np  # noqa: E402

SUM_RTOL = 1e-5


def _assert_values(a, b, op, dtype=np.float32):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape
    if op == "sum" and np.issubdtype(dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=SUM_RTOL, atol=1e-6)
    else:
        np.testing.assert_array_equal(a, b)


def _assert_stats(sa, sb, keys=None):
    keys = sorted(sa) if keys is None else keys
    for k in keys:
        np.testing.assert_array_equal(to_np(sb[k]).astype(np.int64),
                                      to_np(sa[k]).astype(np.int64),
                                      err_msg=k)


def _pgs(layout="csr", n=180, M=8, tau=8):
    """The reference's test graph, partitioned by the reference and carried
    into the port unchanged."""
    g_ref = ref_gen.powerlaw(n, avg_deg=5, seed=1, weighted=True)
    return same_partition(g_ref.symmetrized(), M, tau=tau, seed=0,
                          layout=layout)


# ---------------------------------------------------------------------------
# the plain vector combine against the reference's kernel and ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("F", [1, 8, 32, 130])
def test_vector_blocks_vs_ref(op, F):
    """F=130 crosses the reference's 128-wide feature tile."""
    rng = np.random.RandomState(0)
    nb, eb, n_blocks = 128, 256, 3
    idx = rng.randint(-1, nb, (n_blocks, eb)).astype(np.int32)
    vals = rng.randn(n_blocks, eb, F).astype(np.float32)
    got = torch_blocks(torch.from_numpy(vals), torch.from_numpy(idx), op, nb)
    assert got.shape == (n_blocks, nb, F)
    for want in (pallas_blocks(jnp.asarray(vals), jnp.asarray(idx), op, nb),
                 jnp_blocks(jnp.asarray(vals), jnp.asarray(idx), op, nb)):
        _assert_values(want, got, op)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_vector_blocks_match_per_feature_scalar(op):
    """Each feature of the port's vector combine equals the port's scalar
    combine of that column: bitwise for min/max, rtol=1e-6 for sums."""
    rng = np.random.RandomState(1)
    nb, eb, n_blocks, F = 64, 128, 2, 5
    idx = torch.from_numpy(rng.randint(-1, nb, (n_blocks, eb)
                                       ).astype(np.int32))
    vals = torch.from_numpy(rng.randn(n_blocks, eb, F).astype(np.float32))
    out = torch_blocks(vals, idx, op, nb)
    for f in range(F):
        col = torch_blocks(vals[:, :, f].contiguous(), idx, op, nb)
        if op == "sum":
            np.testing.assert_allclose(out[:, :, f].numpy(), col.numpy(),
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(out[:, :, f].numpy(), col.numpy())


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_f1_bitwise_identical_to_scalar(op):
    rng = np.random.RandomState(2)
    nb, eb, n_blocks = 128, 256, 2
    idx = torch.from_numpy(rng.randint(-1, nb, (n_blocks, eb)
                                       ).astype(np.int32))
    vals = torch.from_numpy(rng.randn(n_blocks, eb).astype(np.float32))
    scalar = torch_blocks(vals, idx, op, nb)
    vec = torch_blocks(vals[..., None], idx, op, nb)
    np.testing.assert_array_equal(scalar.numpy(), vec[:, :, 0].numpy())


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_int_vector_blocks_exact(op):
    """int32, values at the bounds included: sums wrap as the reference's
    int32 accumulation does."""
    rng = np.random.RandomState(3)
    nb, eb, n_blocks, F = 64, 128, 2, 3
    info = np.iinfo(np.int32)
    idx = rng.randint(-1, nb, (n_blocks, eb)).astype(np.int32)
    vals = rng.randint(-1000, 1000, (n_blocks, eb, F)).astype(np.int32)
    vals.reshape(-1)[:3] = [info.min, info.max, -1]
    got = torch_blocks(torch.from_numpy(vals), torch.from_numpy(idx), op, nb)
    assert got.dtype == torch.int32
    want = pallas_blocks(jnp.asarray(vals), jnp.asarray(idx), op, nb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_half_precision_zeros_and_inf(dtype, op):
    """+-0.0 (all ops) and +-inf (min/max) in half precision: min/max
    bitwise against the reference's kernel; sums (float32 accumulation in
    both) within the reference's own 2e-2."""
    rng = np.random.RandomState(4)
    nb, eb, n_blocks, F = 64, 128, 2, 4
    idx = rng.randint(-1, nb, (n_blocks, eb)).astype(np.int32)
    vals = rng.randn(n_blocks, eb, F).astype(np.float32)
    special = (np.array([0.0, -0.0, 1.5, -1.5], np.float32) if op == "sum"
               else np.array([0.0, -0.0, np.inf, -np.inf], np.float32))
    use = rng.rand(*vals.shape) < 0.3
    vals = np.where(use, special[rng.randint(0, 4, vals.shape)], vals)
    jdt = {"float16": jnp.float16, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    vj = jnp.asarray(vals, jdt)
    vt = torch.from_numpy(np.array(vj.astype(jnp.float32))).to(tdt)
    got = torch_blocks(vt, torch.from_numpy(idx), op, nb)
    assert got.dtype == tdt
    want = np.asarray(pallas_blocks(vj, jnp.asarray(idx), op, nb),
                      np.float32)
    g = got.float().numpy()
    if op == "sum":
        np.testing.assert_allclose(g, want, rtol=2e-2, atol=2e-2)
        assert np.isfinite(g).all()
    else:
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_pack_and_segment_combine_vector(op):
    """pack_values / segment_combine on (E, F) payloads."""
    rng = np.random.RandomState(5)
    N, E, F = 300, 1200, 6
    dst = rng.randint(0, N, E)
    vals = rng.randn(E, F).astype(np.float32)
    order, idx = tops.pack_edges(dst, N, nb=128, eb_align=128)
    order_r, idx_r = ref_ops.pack_edges(dst, N, nb=128, eb_align=128)
    pv_t = tops.pack_values(vals, order, idx, op)
    pv_r = ref_ops.pack_values(vals, order_r, idx_r, op)
    assert pv_t.shape == idx.shape + (F,)
    np.testing.assert_array_equal(pv_t, pv_r)
    want = ref_ops.segment_combine(jnp.asarray(pv_r), jnp.asarray(idx_r), op,
                                   128, N)
    got = tops.segment_combine(torch.from_numpy(pv_t), torch.from_numpy(idx),
                               op, 128, N)
    assert got.shape == (N, F)
    _assert_values(want, got, op)
    with pytest.raises(ValueError, match=r"\(E, F\)"):
        tops.pack_values(vals[..., None], order, idx, op)


def test_cpu_vector_dispatch_never_builds_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CUDA kernel was built for a CPU tensor")
    monkeypatch.setattr(tkernel, "build_library", boom)
    monkeypatch.setattr(tkernel, "_library", boom)
    before = tkernel.segment_combine_blocks.launches_vec
    rng = np.random.RandomState(6)
    idx = torch.from_numpy(rng.randint(-1, 32, (4, 16)).astype(np.int32))
    vals = torch.from_numpy(rng.randn(4, 16, 3).astype(np.float32))
    out = tkernel.segment_combine_blocks(vals, idx, "sum", 32)
    assert out.shape == (4, 32, 3)
    assert tkernel.segment_combine_blocks.launches_vec == before
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.launch_vec(vals, idx, "sum", 32)


# ---------------------------------------------------------------------------
# plans: combine_with_plan, chunks, subsets, the sorted combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_combine_with_plan_vector(layout, op):
    """(E, F) values through the plan equal the reference's, and the stats
    are the scalar combine's."""
    pg_ref, pg_t = _pgs(layout)
    F = 4
    pr = rplan.get_plan(pg_ref, "eg", nb=32)
    pt = tplan.get_plan(pg_t, "eg", nb=32)
    E = int(np.asarray(pg_ref.eg_dst).size)
    rng = np.random.RandomState(7)
    vals = rng.randn(E, F).astype(np.float32)
    hits = rng.rand(E) > 0.2
    a, sa = rplan.combine_with_plan(pr, jnp.asarray(vals), op,
                                    flat_hits=jnp.asarray(hits))
    b, sb = tplan.combine_with_plan(pt, torch.from_numpy(vals), op,
                                    flat_hits=torch.from_numpy(hits))
    assert tuple(b.shape) == (pg_t.M, pg_t.n_loc, F)
    _assert_values(a, b, op)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(to_np(y).astype(np.int64),
                                      to_np(x).astype(np.int64))
    _, ss = tplan.combine_with_plan(pt, torch.from_numpy(vals[:, 0]), op,
                                    flat_hits=torch.from_numpy(hits))
    for x, y in zip(ss, sb):
        np.testing.assert_array_equal(to_np(y), to_np(x))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_chunked_vector_combine_equals_one_chunk(op, monkeypatch):
    """Chunks of a few rows give what one chunk gives: min/max bitwise,
    sums to round-off; an EdgeMap gives what its array gives."""
    _, pg_t = _pgs("csr")
    plan = tplan.get_plan(pg_t, "eg", nb=16, eb=8)
    E = pg_t.eg_dst.shape[0]
    rng = np.random.RandomState(8)
    vals = torch.from_numpy(rng.randn(E, 5).astype(np.float32))
    whole, _ = tplan.combine_with_plan(plan, vals, op, count_cross=False)
    per_row = (plan.eb + plan.nb) * 5 * 4
    monkeypatch.setattr(tplan, "VEC_CHUNK_BYTES", 3 * per_row)
    assert tplan.vec_chunk_rows(plan, 5) == 3
    assert tplan.vec_chunks(plan, 5) == -(-plan.n_rows // 3) > 2
    chunked, _ = tplan.combine_with_plan(plan, vals, op, count_cross=False)
    lazy, _ = tplan.combine_with_plan(plan, tplan.EdgeMap.of(vals), op,
                                      count_cross=False)
    _assert_values(whole, chunked, op)
    np.testing.assert_array_equal(chunked.numpy(), lazy.numpy())


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_combine_rows_subset_vector(op):
    pg_ref, pg_t = _pgs("csr")
    pr = rplan.get_plan(pg_ref, "eg", nb=32)
    pt = tplan.get_plan(pg_t, "eg", nb=32)
    E = int(np.asarray(pg_ref.eg_dst).size)
    rng = np.random.RandomState(9)
    vals = rng.randn(E, 3).astype(np.float32)
    rows = np.array([0, 3, 1, 2], np.int32) % max(pr.n_rows, 1)
    ok = np.array([True, True, False, True])
    a = rplan.combine_rows_subset(pr, jnp.asarray(vals), jnp.asarray(rows),
                                  jnp.asarray(ok), op)
    b = tplan.combine_rows_subset(pt, torch.from_numpy(vals),
                                  torch.from_numpy(rows),
                                  torch.from_numpy(ok), op)
    _assert_values(a, b, op)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_combine_sorted_vector(op):
    M, n_loc, K, F = 5, 30, 40, 3
    rng = np.random.RandomState(10)
    targets = rng.randint(0, M * n_loc, (M, K)).astype(np.int32)
    values = rng.randn(M, K, F).astype(np.float32)
    mask = rng.rand(M, K) > 0.3
    a, sa = rplan.combine_sorted(jnp.asarray(targets), jnp.asarray(values),
                                 jnp.asarray(mask), op, M, n_loc)
    b, sb = tplan.combine_sorted(torch.from_numpy(targets),
                                 torch.from_numpy(values),
                                 torch.from_numpy(mask), op, M, n_loc)
    _assert_values(a, b, op)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(to_np(y).astype(np.int64),
                                      to_np(x).astype(np.int64))
    worker = np.repeat(np.arange(M), K).astype(np.int32)
    args = (targets.reshape(-1), values.reshape(-1, F), mask.reshape(-1),
            worker)
    a, sa = rplan.combine_sorted_flat(*map(jnp.asarray, args), op, M, n_loc)
    b, sb = tplan.combine_sorted_flat(*map(torch.from_numpy, args), op, M,
                                      n_loc)
    _assert_values(a, b, op)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(to_np(y).astype(np.int64),
                                      to_np(x).astype(np.int64))


# ---------------------------------------------------------------------------
# channels: vector payloads vs the reference and vs per-feature scalar runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_push_combined_vector(op, backend):
    M, n_loc, K, F = 4, 25, 30, 3
    rng = np.random.RandomState(11)
    targets = rng.randint(0, M * n_loc, (M, K)).astype(np.int32)
    values = rng.randn(M, K, F).astype(np.float32)
    mask = rng.rand(M, K) > 0.3
    a = rch.push_combined(jnp.asarray(targets), jnp.asarray(values),
                          jnp.asarray(mask), op, M, n_loc, backend=backend)
    b = tch.push_combined(torch.from_numpy(targets),
                          torch.from_numpy(values), torch.from_numpy(mask),
                          op, M, n_loc, backend=backend)
    _assert_values(a[0], b[0], op)
    _assert_stats(a[1], b[1])
    worker = np.repeat(np.arange(M), K).astype(np.int32)
    args = (targets.reshape(-1), values.reshape(-1, F), mask.reshape(-1),
            worker)
    a = rch.push_combined_flat(*map(jnp.asarray, args), op, M, n_loc,
                               backend=backend)
    b = tch.push_combined_flat(*map(torch.from_numpy, args), op, M, n_loc,
                               backend=backend)
    _assert_values(a[0], b[0], op)
    _assert_stats(a[1], b[1])


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("relay", ["none", "mul_w", "add_w"])
def test_push_mirror_vector(layout, backend, relay):
    pg_ref, pg_t = _pgs(layout)
    rng = np.random.RandomState(12)
    vals = rng.randn(pg_t.M, pg_t.n_loc, 4).astype(np.float32)
    act = rng.rand(pg_t.M, pg_t.n_loc) > 0.3
    a = rch.push_mirror(pg_ref, jnp.asarray(vals), jnp.asarray(act), "min",
                        relay, backend=backend)
    b = tch.push_mirror(pg_t, torch.from_numpy(vals), torch.from_numpy(act),
                        "min", relay, backend=backend)
    _assert_values(a[0], b[0], "min")
    _assert_stats(a[1], b[1])


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("op", ["sum", "min"])
def test_broadcast_vector_matches_per_feature(layout, backend, op):
    """The vector broadcast equals the reference's and, feature by
    feature, the port's scalar broadcast (min bitwise, sum to round-off);
    its stats are the scalar broadcast's: one (F,) block per active
    lane."""
    F = 3
    pg_ref, pg_t = _pgs(layout)
    rng = np.random.RandomState(6)
    vals = rng.randn(pg_t.M, pg_t.n_loc, F).astype(np.float32)
    act = rng.rand(pg_t.M, pg_t.n_loc) > 0.3
    a, sa = rch.broadcast(pg_ref, jnp.asarray(vals), jnp.asarray(act), op,
                          relay="mul_w", backend=backend)
    out, stats = tch.broadcast(pg_t, torch.from_numpy(vals),
                               torch.from_numpy(act), op, relay="mul_w",
                               backend=backend)
    assert tuple(out.shape) == (pg_t.M, pg_t.n_loc, F)
    _assert_values(a, out, op)
    _assert_stats(sa, stats)
    for f in range(F):
        ref, rs = tch.broadcast(pg_t, torch.from_numpy(vals[:, :, f]),
                                torch.from_numpy(act), op, relay="mul_w",
                                backend=backend)
        _assert_values(ref, out[:, :, f], op)
        _assert_stats(rs, stats)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_broadcast_f1_bitwise_identical(backend):
    _, pg_t = _pgs("csr")
    rng = np.random.RandomState(7)
    vals = torch.from_numpy(rng.randn(pg_t.M, pg_t.n_loc).astype(np.float32))
    act = torch.from_numpy(rng.rand(pg_t.M, pg_t.n_loc) > 0.3)
    s_out, _ = tch.broadcast(pg_t, vals, act, "min", backend=backend)
    v_out, _ = tch.broadcast(pg_t, vals[..., None], act, "min",
                             backend=backend)
    np.testing.assert_array_equal(s_out.numpy(), v_out[:, :, 0].numpy())


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_broadcast_without_counts(layout):
    """count=False returns no stats and the same inbox."""
    _, pg_t = _pgs(layout)
    rng = np.random.RandomState(13)
    vals = torch.from_numpy(rng.randn(pg_t.M, pg_t.n_loc, 2
                                      ).astype(np.float32))
    act = torch.ones(pg_t.M, pg_t.n_loc, dtype=torch.bool)
    for backend in ("dense", "pallas"):
        a, sa = tch.broadcast(pg_t, vals, act, "max", relay="mul_w",
                              backend=backend)
        b, sb = tch.broadcast(pg_t, vals, act, "max", relay="mul_w",
                              backend=backend, count=False)
        assert sb == {} and "msgs_total" in sa
        np.testing.assert_array_equal(a.numpy(), b.numpy())
