"""The port on the card: the CUDA segment_combine kernels (scalar and
vector), the flash attention kernel and the SSD chunk scan kernel against
their plain PyTorch versions, and the main paths at a small size (the
algorithms, the request-respond ones among them, and GCN training with the
kernels against the dense backend and the CPU, Hash-Min and S-V on the
sharded executor over an NCCL group of size 1 (the 1-D mesh, the (1, 1)
mesh, the pipeline and a split partition), the resident graph service
over such a group against the same service on the CPU, a hybrid model's,
a head-dim-256 Gemma-3 model's and a small Whisper's prefill and decode
with the kernels against the plain path).  The segment_combine kernels
also on float16 and bfloat16 payloads, the flash kernel on unmasked
rectangular shapes (cross-attention) and on float16, the SSD scan on
float16 and bfloat16 inputs, both kernels' ``autograd.Function``s (the
kernel forward, the plain backward) against float64 autograd, and a small
LM's train step through them.

Every test here carries the ``cuda`` marker and skips without a GPU.  The
file imports no JAX, so it runs on a machine with a card and PyTorch only:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Engine  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.kernels.segment_combine import kernel as tkernel  # noqa: E402
from repro_torch.kernels.segment_combine.ref import (  # noqa: E402
    segment_combine_blocks_ref)

pytestmark = pytest.mark.cuda
SHAPES = [(8, 32, 7), (64, 128, 5), (512, 32, 3), (512, 128, 1000),
          (37, 100, 300)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(op, dtype, eb, nb, rows, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, nb, (rows, eb)).astype(np.int32)
    if dtype == torch.int32:
        info = np.iinfo(np.int32)
        vals = rng.randint(info.min, info.max, (rows, eb),
                           dtype=np.int64).astype(np.int32)
        vals.reshape(-1)[:3] = [info.min, info.max, -1]
    else:
        vals = rng.randn(rows, eb).astype(np.float32)
        if op != "sum":
            vals.reshape(-1)[:2] = [np.inf, -np.inf]
    return torch.from_numpy(vals), torch.from_numpy(idx)


@pytest.mark.parametrize("eb,nb,rows", SHAPES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_kernel_matches_plain(cuda, op, dtype, eb, nb, rows):
    """Integers and min/max bitwise; a float32 sum within the bound of
    summing eb terms in another order (2*eb*2^-24 of the sum of |v|)."""
    vals, idx = _inputs(op, dtype, eb, nb, rows, seed=rows)
    before = tkernel.segment_combine_blocks.launches
    got = tkernel.segment_combine_blocks(vals.to(cuda), idx.to(cuda), op, nb)
    torch.cuda.synchronize()
    assert tkernel.segment_combine_blocks.launches == before + 1
    want = segment_combine_blocks_ref(vals, idx, op, nb)
    if op == "sum" and dtype == torch.float32:
        bound = (2 * eb * 2.0 ** -24
                 * segment_combine_blocks_ref(vals.abs(), idx, "sum", nb))
        assert ((got.cpu() - want).abs() <= bound).all()
    else:
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_kernel_rejects_what_it_does_not_take(cuda):
    vals, idx = _inputs("min", torch.float32, 8, 32, 4, seed=0)
    v, i = vals.to(cuda), idx.to(cuda)
    assert tkernel.launch(v.to(torch.bfloat16), i, "min",
                          32).dtype == torch.bfloat16
    assert tkernel.launch_vec(v[..., None].to(torch.float16), i, "min",
                              32).dtype == torch.float16
    with pytest.raises(TypeError, match="dtype"):
        tkernel.launch(v.double(), i, "min", 32)
    with pytest.raises(ValueError, match="3-D"):
        tkernel.launch_vec(v, i, "min", 32)
    with pytest.raises(ValueError, match="2-D"):
        tkernel.launch(v[..., None], i, "min", 32)
    with pytest.raises(ValueError):
        tkernel.segment_combine_blocks(v[..., None, None], i, "min", 32)
    with pytest.raises(TypeError):
        tkernel.launch(v, i.long(), "min", 32)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.launch(v.t().contiguous().t(), i.t().contiguous().t(),
                       "min", 32)
    with pytest.raises(ValueError, match="nb"):
        tkernel.launch(v, i, "min", 2048)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.launch(vals, i, "min", 32)


VEC_SHAPES = [(8, 32, 7, 1), (64, 128, 50, 3), (64, 128, 300, 32),
              (512, 128, 20, 64), (37, 100, 30, 130), (64, 1024, 5, 33)]


def _vec_inputs(op, dtype, eb, nb, rows, F, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, nb, (rows, eb)).astype(np.int32)
    if dtype == torch.int32:
        info = np.iinfo(np.int32)
        vals = rng.randint(info.min, info.max, (rows, eb, F),
                           dtype=np.int64).astype(np.int32)
        vals.reshape(-1)[:3] = [info.min, info.max, -1]
    else:
        vals = rng.randn(rows, eb, F).astype(np.float32)
        if op != "sum":
            vals.reshape(-1)[:2] = [np.inf, -np.inf]
    return torch.from_numpy(vals), torch.from_numpy(idx)


@pytest.mark.parametrize("eb,nb,rows,F", VEC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_vector_kernel_matches_plain(cuda, op, dtype, eb, nb, rows, F):
    """Integers and min/max bitwise; a float32 sum within the bound of
    summing eb terms in another order (2*eb*2^-24 of the sum of |v|)."""
    vals, idx = _vec_inputs(op, dtype, eb, nb, rows, F, seed=rows + F)
    before = tkernel.segment_combine_blocks.launches_vec
    got = tkernel.segment_combine_blocks(vals.to(cuda), idx.to(cuda), op, nb)
    torch.cuda.synchronize()
    assert tkernel.segment_combine_blocks.launches_vec == before + 1
    assert got.shape == (rows, nb, F)
    want = segment_combine_blocks_ref(vals, idx, op, nb)
    if op == "sum" and dtype == torch.float32:
        bound = (2 * eb * 2.0 ** -24
                 * segment_combine_blocks_ref(vals.abs(), idx, "sum", nb))
        assert ((got.cpu() - want).abs() <= bound).all()
    else:
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_vector_kernel_f1_equals_scalar_kernel(cuda, op, dtype):
    """F=1 through the vector kernel is the scalar kernel, bit for bit
    (same lanes, same order, same arithmetic)."""
    vals, idx = _vec_inputs(op, dtype, 64, 128, 500, 1, seed=5)
    v, i = vals.to(cuda), idx.to(cuda)
    vec = tkernel.launch_vec(v, i, op, 128)
    scalar = tkernel.launch(v[:, :, 0].contiguous(), i, op, 128)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(vec[:, :, 0].cpu().numpy(),
                                  scalar.cpu().numpy())


# ---------------------------------------------------------------------------
# float16 and bfloat16 payloads
# ---------------------------------------------------------------------------

HALF = [torch.float16, torch.bfloat16]


def _half_inputs(op, dtype, eb, nb, rows, F, seed):
    """Random half values with +-0.0 everywhere and, for min/max, +-inf
    (infinities stay out of sums, as in the reference's own test); float16
    values also at +-65504, its sentinels."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, nb + 3, (rows, eb)).astype(np.int32)
    idx[0] = rng.randint(0, nb)
    shape = (rows, eb) if F is None else (rows, eb, F)
    vals = rng.randn(*shape).astype(np.float32)
    special = (np.array([0.0, -0.0, 1.5, -1.5], np.float32) if op == "sum"
               else np.array([0.0, -0.0, np.inf, -np.inf], np.float32))
    use = rng.rand(*shape) < 0.3
    vals = np.where(use, special[rng.randint(0, 4, shape)], vals)
    if op != "sum" and dtype == torch.float16:
        vals.reshape(-1)[:2] = [65504.0, -65504.0]
    return torch.from_numpy(vals).to(dtype), torch.from_numpy(idx)


def _half_lane_sum(vals, idx, nb):
    """The kernels' half sum: float32 folded in lane order from 0, then
    one rounding to the half type."""
    return torch.from_numpy(_lane_order_sum(vals.float(), idx, nb)).to(
        vals.dtype)


@pytest.mark.parametrize("F", [None, 1, 3, 8, 64, 256])
@pytest.mark.parametrize("eb,nb", [(64, 128), (37, 100), (2048, 1024)])
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_half_kernels_match_plain(cuda, op, dtype, eb, nb, F):
    """float16 and bfloat16 through both kernels (F=256 takes 8 values a
    load): min and max equal to the plain version (the sentinels +-65504
    for float16, 3e38 rounded for bfloat16, which an infinity saturates
    to), sums bitwise equal to the float32 lane-order fold rounded once;
    the output keeps the input type."""
    rows = 3 if eb * (F or 1) > 2 ** 16 else 50
    vals, idx = _half_inputs(op, dtype, eb, nb, rows, F, seed=eb + (F or 0))
    counter = "launches" if F is None else "launches_vec"
    before = getattr(tkernel.segment_combine_blocks, counter)
    got = tkernel.segment_combine_blocks(vals.to(cuda), idx.to(cuda), op, nb)
    torch.cuda.synchronize()
    assert getattr(tkernel.segment_combine_blocks, counter) == before + 1
    assert got.dtype == dtype
    if op == "sum":
        want = _half_lane_sum(vals, idx, nb)
        assert torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16))
    else:
        want = segment_combine_blocks_ref(vals, idx, op, nb)
        np.testing.assert_array_equal(got.cpu().float().numpy(),
                                      want.float().numpy())


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_half_vector_f1_equals_scalar(cuda, op, dtype):
    vals, idx = _half_inputs(op, dtype, 64, 128, 500, 1, seed=7)
    v, i = vals.to(cuda), idx.to(cuda)
    vec = tkernel.launch_vec(v, i, op, 128)
    scalar = tkernel.launch(v[:, :, 0].contiguous(), i, op, 128)
    torch.cuda.synchronize()
    assert torch.equal(vec[:, :, 0].view(torch.int16),
                       scalar.view(torch.int16))


@pytest.mark.parametrize("op", ["min", "max"])
def test_half_identity_remap_through_combine_rows(cuda, op):
    """``plan._combine_rows`` on a float16 payload on the card: slots that
    no edge reaches come back as the channel identity (+-inf), not the
    kernel's +-65504, and the others as numpy's reduction."""
    from repro_torch.kernels.segment_combine.ops import (pack_edges,
                                                         pack_values)
    rng = np.random.RandomState(5)
    N, E, nb = 200, 600, 64
    dst = rng.randint(0, N // 2, E)
    vals = rng.randn(E).astype(np.float16)
    order, idxl = pack_edges(dst, N, nb=nb, eb_align=128)
    pv = pack_values(vals, order, idxl, op)
    before = tkernel.segment_combine_blocks.launches
    blocks = tplan._combine_rows(torch.from_numpy(pv).to(cuda),
                                 torch.from_numpy(idxl).to(cuda), op, nb)
    torch.cuda.synchronize()
    assert tkernel.segment_combine_blocks.launches == before + 1
    out = blocks.cpu().numpy().reshape(-1)[:N]
    ident = np.float16(np.inf if op == "min" else -np.inf)
    ref = np.full(N, ident, np.float16)
    (np.minimum if op == "min" else np.maximum).at(ref, dst, vals)
    np.testing.assert_array_equal(out, ref)
    assert (out[N // 2:] == ident).all()


# ---------------------------------------------------------------------------
# edge cases, determinism and lane order of both segment_combine kernels
# ---------------------------------------------------------------------------

EDGE_EB = [0, 1, 31, 33, 2048]
EDGE_NB = [1, 128, 1024]


def _edge_inputs(dtype, eb, nb, rows, F, seed):
    """Indices in [-1, nb + 3) (so nb and beyond appear), with row 0 all
    on one slot, row 1 all padding and row 2 all at nb or beyond; values
    as ``_vec_inputs``, (rows, eb) for ``F=None``."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, nb + 3, (rows, eb)).astype(np.int32)
    idx[0] = rng.randint(0, nb)
    idx[1] = -1
    idx[2] = nb + rng.randint(0, 3, eb)
    shape = (rows, eb) if F is None else (rows, eb, F)
    if dtype == torch.int32:
        info = np.iinfo(np.int32)
        vals = rng.randint(info.min, info.max, shape,
                           dtype=np.int64).astype(np.int32)
    else:
        vals = rng.randn(*shape).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(idx)


def _lane_order_sum(vals, idx, nb):
    """float32 sums folded lane by lane, in lane order, from 0: numpy's
    unbuffered ``np.add.at`` over each row's hitting lanes."""
    v, i = vals.numpy(), idx.numpy()
    R = i.shape[0]
    hit = (i >= 0) & (i < nb)
    flat = (np.arange(R)[:, None] * nb + i)[hit]
    out = np.zeros((R * nb,) + v.shape[2:], np.float32)
    np.add.at(out, flat, v[hit])
    return out.reshape((R, nb) + v.shape[2:])


def _check_edge(got, vals, idx, op, nb):
    want = segment_combine_blocks_ref(vals, idx, op, nb)
    assert got.shape == want.shape and got.dtype == want.dtype
    if op == "sum" and vals.dtype == torch.float32:
        # lane order from 0 is the kernels' contract: bitwise
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _lane_order_sum(vals, idx, nb))
    else:
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("nb", EDGE_NB)
@pytest.mark.parametrize("eb", EDGE_EB)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_kernel_edge_cases(cuda, op, dtype, eb, nb):
    """Skewed, all-padding and out-of-range rows, every eb and nb edge:
    integers and min/max bitwise against the plain version, float32 sums
    bitwise against the lane-order fold."""
    rows = 40 if eb < 2048 else 9
    vals, idx = _edge_inputs(dtype, eb, nb, rows, None, seed=eb + nb)
    before = tkernel.segment_combine_blocks.launches
    got = tkernel.segment_combine_blocks(vals.to(cuda), idx.to(cuda), op, nb)
    torch.cuda.synchronize()
    assert tkernel.segment_combine_blocks.launches == before + 1
    _check_edge(got, vals, idx, op, nb)


@pytest.mark.parametrize("F", [1, 33, 130, 256])
@pytest.mark.parametrize("nb", EDGE_NB)
@pytest.mark.parametrize("eb", EDGE_EB)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_vector_kernel_edge_cases(cuda, op, dtype, eb, nb, F):
    """The vector kernel on the same rows, F ragged and over several
    feature tiles (eb=2048 takes two lane tiles)."""
    rows = 3 if eb * F > 2 ** 16 else 20
    vals, idx = _edge_inputs(dtype, eb, nb, rows, F, seed=eb + nb + F)
    before = tkernel.segment_combine_blocks.launches_vec
    got = tkernel.segment_combine_blocks(vals.to(cuda), idx.to(cuda), op, nb)
    torch.cuda.synchronize()
    assert tkernel.segment_combine_blocks.launches_vec == before + 1
    _check_edge(got, vals, idx, op, nb)


@pytest.mark.parametrize("F", [None, 1, 32, 64])
def test_kernels_are_deterministic(cuda, F):
    """Two launches on the same float32 inputs give the same sums, bit for
    bit (skewed rows included)."""
    vals, idx = _edge_inputs(torch.float32, 512, 128, 300, F, seed=11)
    v, i = vals.to(cuda), idx.to(cuda)
    a = tkernel.segment_combine_blocks(v, i, "sum", 128)
    b = tkernel.segment_combine_blocks(v, i, "sum", 128)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("F", [None, 1, 3, 32, 64, 130])
def test_float_sums_fold_in_lane_order(cuda, F):
    """The float32 sum of each slot (per feature) equals numpy's lane-order
    fold from 0, bit for bit, at the main path's shapes."""
    for eb, nb in ((64, 128), (512, 128)):
        vals, idx = _edge_inputs(torch.float32, eb, nb, 200, F, seed=eb)
        got = tkernel.segment_combine_blocks(vals.to(cuda), idx.to(cuda),
                                             "sum", nb)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _lane_order_sum(vals, idx, nb))


def test_entry_points_refuse_a_bad_geometry(cuda):
    """The C entry points check the geometry they are given again and
    return cudaErrorInvalidValue (1) on a value the kernels do not take."""
    vals, idx = _inputs("sum", torch.float32, 64, 128, 10, seed=1)
    v, i = vals.to(cuda), idx.to(cuda)
    out = torch.empty((10, 128), device=cuda)
    lib = tkernel._library()
    stream = torch.cuda.current_stream().cuda_stream
    geo = tkernel.launch_geometry(10, 64, 128)
    args = [v.data_ptr(), i.data_ptr(), out.data_ptr(), 10, 64, 128, 1, 0]
    good = (geo.warps, geo.lane_tile, geo.smem_bytes, geo.blocks)
    assert lib.segment_combine_launch(*args, *good, cuda.index or 0,
                                      stream) == 0
    for bad in [(geo.warps, geo.lane_tile, geo.smem_bytes + 4, geo.blocks),
                (geo.warps, 48, geo.smem_bytes, geo.blocks),
                (64, geo.lane_tile, 64 * geo.smem_bytes // geo.warps,
                 geo.blocks),
                (geo.warps, geo.lane_tile, geo.smem_bytes, 0)]:
        assert lib.segment_combine_launch(*args, *bad, cuda.index or 0,
                                          stream) == 1
    v3 = v[..., None].expand(10, 64, 4).contiguous()
    out3 = torch.empty((10, 128, 4), device=cuda)
    g3 = tkernel.launch_geometry(10, 64, 128, 4)
    args3 = [v3.data_ptr(), i.data_ptr(), out3.data_ptr(), None, 10, 64,
             128, 4, 1, 0]
    assert lib.segment_combine_vec_launch(
        *args3, g3.vec, g3.warps, g3.lane_tile, g3.smem_bytes, g3.blocks,
        cuda.index or 0, stream) == 0
    for vec in (3, 8):
        assert lib.segment_combine_vec_launch(
            *args3, vec, g3.warps, g3.lane_tile, g3.smem_bytes, g3.blocks,
            cuda.index or 0, stream) == 1
    # float16 (dtype 2): 8 values (16 bytes) a load, never 16
    v8 = v[..., None].expand(10, 64, 8).contiguous().half()
    out8 = torch.empty((10, 128, 8), device=cuda, dtype=torch.float16)
    args8 = [v8.data_ptr(), i.data_ptr(), out8.data_ptr(), None, 10, 64,
             128, 8, 2, 0]
    for vec, rc in ((8, 0), (16, 1)):
        assert lib.segment_combine_vec_launch(
            *args8, vec, g3.warps, g3.lane_tile, g3.smem_bytes, g3.blocks,
            cuda.index or 0, stream) == rc
    # a half row longer than its lane tile needs the float32 scratch
    g2 = tkernel.launch_geometry(10, 2048, 128, 8, itemsize=2)
    v2 = torch.zeros((10, 2048, 8), device=cuda, dtype=torch.float16)
    i2 = torch.zeros((10, 2048), device=cuda, dtype=torch.int32)
    part = torch.empty((10, 128, 8), device=cuda)
    for ptr, rc in ((None, 1), (part.data_ptr(), 0)):
        assert lib.segment_combine_vec_launch(
            v2.data_ptr(), i2.data_ptr(), out8.data_ptr(), ptr, 10, 2048,
            128, 8, 2, 0, g2.vec, g2.warps, g2.lane_tile, g2.smem_bytes,
            g2.blocks, cuda.index or 0, stream) == rc
    assert lib.segment_combine_launch(*args[:6], 4, 0, *good,
                                      cuda.index or 0, stream) == 1
    torch.cuda.synchronize()


def test_gcn_on_the_card(cuda, monkeypatch):
    """Engine.run("gcn") on the card goes through the vector kernel (as
    many launches as the plan chunks predict, no scalar launch) and its
    loss history equals the dense backend's and the CPU's (rtol=1e-4)."""
    from repro_torch.train.gcn import normalize_adjacency
    g = normalize_adjacency(tgen.powerlaw(3000, avg_deg=8,
                                          seed=1).symmetrized())
    kw = dict(feat_dim=32, hidden=64, n_classes=8, epochs=3, lr=1e-2)
    # a few rows a chunk, so a join runs several launches
    monkeypatch.setattr(tplan, "VEC_CHUNK_BYTES", 1 << 20)
    hist = {}
    for device, backend in [(cuda, "pallas"), (cuda, "dense"),
                            ("cpu", "pallas")]:
        eng = Engine(backend=backend, layout="csr", device=device)
        pg = eng.partition(g, 8, tau=20, seed=0)
        before = (tkernel.segment_combine_blocks.launches,
                  tkernel.segment_combine_blocks.launches_vec)
        res = eng.run("gcn", pg, **kw)
        torch.cuda.synchronize()
        scalar = tkernel.segment_combine_blocks.launches - before[0]
        vec = tkernel.segment_combine_blocks.launches_vec - before[1]
        if device == cuda and backend == "pallas":
            per_epoch = 2 * sum(tplan.vec_chunks(tplan.get_plan(pg, k), F)
                                for k in ("eg", "mir") for F in (32, 64))
            assert per_epoch > 8
            assert (scalar, vec) == (0, per_epoch * kw["epochs"])
        else:
            assert (scalar, vec) == (0, 0)
        hist[(str(device), backend)] = res.history
    base = hist[(str(cuda), "pallas")]
    assert base[-1] < base[0]
    for h in hist.values():
        np.testing.assert_allclose(h, base, rtol=1e-4)


@pytest.mark.parametrize("algo,params", [("hashmin", {}),
                                         ("pagerank", {"n_iters": 10,
                                                       "tol": 0.0}),
                                         ("sssp", {"source": 0})])
def test_main_path_on_the_card(cuda, algo, params):
    """Engine(backend="pallas") on the card goes through the kernel (3
    launches a superstep) and equals the dense backend and the CPU run."""
    g = tgen.powerlaw(3000, avg_deg=8, seed=1, weighted=True).symmetrized()
    runs = {}
    for device, backend in [(cuda, "pallas"), (cuda, "dense"),
                            ("cpu", "pallas")]:
        eng = Engine(backend=backend, layout="csr", device=device)
        pg = eng.partition(g, 8, tau=20, seed=0)
        before = tkernel.segment_combine_blocks.launches
        res = eng.run(algo, pg, **params)
        launches = tkernel.segment_combine_blocks.launches - before
        if device == cuda and backend == "pallas":
            assert launches == 3 * res.n_supersteps
        else:
            assert launches == 0
        runs[(str(device), backend)] = res
    base = runs[(str(cuda), "pallas")]
    for res in runs.values():
        assert res.n_supersteps == base.n_supersteps
        for k in base.stats:
            np.testing.assert_array_equal(np.asarray(res.stats[k]),
                                          np.asarray(base.stats[k]))
        a, b = res.state.cpu().numpy(), base.state.cpu().numpy()
        if algo == "pagerank":
            np.testing.assert_allclose(a, b, rtol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["csr", "padded"])
@pytest.mark.parametrize("algo", ["sv", "msf", "attr_bcast"])
def test_request_respond_on_the_card(cuda, algo, layout):
    """S-V, MSF and attribute broadcast on the card (pallas and dense)
    equal the CPU run through the plain path: labels, MSF's edge count and
    the attributes bitwise, MSF's weight (float32 sums in another order)
    within 1e-6, every stat equal; S-V goes through the kernel twice a
    superstep (the all plan's values and hit counts), the others never."""
    g = tgen.powerlaw(3000, avg_deg=8, seed=1, weighted=True).symmetrized()
    runs = {}
    for device, backend in [(cuda, "pallas"), (cuda, "dense"),
                            ("cpu", "pallas")]:
        eng = Engine(backend=backend, layout=layout, device=device)
        pg = eng.partition(g, 8, tau=20, seed=0)
        params = {}
        if algo == "attr_bcast":
            params["attr"] = 3 * torch.arange(
                pg.n_pad, dtype=torch.float32, device=pg.device).view(
                    pg.M, pg.n_loc)
        before = tkernel.segment_combine_blocks.launches
        res = eng.run(algo, pg, **params)
        launches = tkernel.segment_combine_blocks.launches - before
        on_kernel = algo == "sv" and device == cuda and backend == "pallas"
        assert launches == (2 * res.n_supersteps if on_kernel else 0)
        runs[(str(device), backend)] = res
    base = runs[("cpu", "pallas")]
    for res in runs.values():
        assert res.n_supersteps == base.n_supersteps
        assert set(res.stats) == set(base.stats)
        for k in base.stats:
            np.testing.assert_array_equal(np.asarray(res.stats[k]),
                                          np.asarray(base.stats[k]))
        if algo == "msf":
            (la, wa, na), (lb, wb, nb) = res.state, base.state
            np.testing.assert_array_equal(la.cpu().numpy(), lb.numpy())
            assert int(na) == int(nb)
            np.testing.assert_allclose(float(wa), float(wb), rtol=1e-6)
        else:
            np.testing.assert_array_equal(res.state.cpu().numpy(),
                                          base.state.numpy())


@pytest.mark.parametrize("algo", ["hashmin", "sv"])
def test_sharded_on_one_card_over_nccl(cuda, algo):
    """The sharded executor through an in-process NCCL group of size 1
    equals the single-device run on the card: labels bitwise, every stat
    equal, the same supersteps and the same kernel launches a superstep
    (this rank's plan rows go through the scalar kernel)."""
    import datetime
    import torch.distributed as dist
    g = tgen.powerlaw(3000, avg_deg=8, seed=1, weighted=True).symmetrized()
    one = Engine(backend="pallas", layout="csr", device=cuda)
    pg = one.partition(g, 8, tau=20, seed=0)
    runs = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        sharded = Engine(backend="pallas", layout="csr", devices=1,
                         device=cuda)
        for name, eng in (("one", one), ("sharded", sharded)):
            before = tkernel.segment_combine_blocks.launches
            res = eng.run(algo, pg)
            torch.cuda.synchronize()
            runs[name] = (res, tkernel.segment_combine_blocks.launches
                          - before)
    finally:
        dist.destroy_process_group()
    (a, la), (b, lb) = runs["one"], runs["sharded"]
    assert b.n_supersteps == a.n_supersteps
    assert la == lb == (3 if algo == "hashmin" else 2) * a.n_supersteps
    assert torch.equal(a.state, b.state)
    assert set(a.stats) == set(b.stats)
    for k in a.stats:
        np.testing.assert_array_equal(np.asarray(b.stats[k]),
                                      np.asarray(a.stats[k]))
    assert b.sharded["host_reads"] >= b.n_supersteps


def test_graph_service_on_one_card_over_nccl(cuda):
    """The resident graph service on the card (an in-process NCCL group of
    world size 1, n=3000): a mixed batch, a 2% churn fold and the batch
    again equal the same service on the CPU (a gloo group) answer for
    answer (SSSP and ego bitwise, PPR within 1e-5 of its max: float sums
    in another order), with the same statistics; the executor counter
    stays flat and the card tables keep their storage across the fold."""
    import datetime
    import torch.distributed as dist
    from repro_torch.api import EngineConfig
    from repro_torch.core import exec as texec
    from repro_torch.core.service import GraphClient, GraphService, Query
    from repro_torch.launch.serve_graph import churn_delta, mixed_batch
    g = tgen.powerlaw(3000, avg_deg=8, seed=1, weighted=True).symmetrized()
    batch = mixed_batch(g.n, 24, 0)
    delta = churn_delta(g, 0.02, 0)
    out = {}
    for backend, dev in (("gloo", "cpu"), ("nccl", cuda)):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            svc = GraphService(g, M=8, config=EngineConfig(
                layout="csr", balance="edges", devices=1),
                buckets=(4, 16), ppr_iters=10, device=dev)
            svc.warmup()
            traces = svc.traces
            ptrs = {k: t.data_ptr() for k, t in texec._tensors(svc.sg)}
            client = GraphClient(svc)
            pre = client.request(batch)
            pre_stats = svc.last_batch["stats"]
            svc.mutate(delta)
            post = client.request([Query("sssp", 17)] + batch)
            torch.cuda.synchronize()
            assert svc.traces == traces and svc.epoch == 1
            assert ptrs == {k: t.data_ptr()
                            for k, t in texec._tensors(svc.sg)}
            assert all(t.device.type == torch.device(dev).type
                       for _, t in texec._tensors(svc.sg))
            out[backend] = (pre, pre_stats, post, svc.last_batch["stats"])
        finally:
            dist.destroy_process_group()
    (a0, sa0, a1, sa1), (b0, sb0, b1, sb1) = out["gloo"], out["nccl"]
    for want, got in ((a0, b0), (a1, b1)):
        for x, y in zip(want, got):
            assert (x.query, x.epoch, x.cached) == (y.query, y.epoch,
                                                    y.cached)
            if x.query.kind == "ppr":
                assert float(np.abs(y.value - x.value).max()) <= (
                    1e-5 * float(np.abs(x.value).max()))
            elif x.query.kind == "sssp":
                np.testing.assert_array_equal(y.value, x.value)
            else:
                assert y.value == x.value
    for want, got in ((sa0, sb0), (sa1, sb1)):
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("mode", ["mesh", "pipeline", "split"])
@pytest.mark.parametrize("algo", ["hashmin", "sv"])
def test_mesh_pipeline_split_on_one_card_over_nccl(cuda, algo, mode,
                                                 monkeypatch):
    """``devices=(1, 1)`` (the hierarchical exchanges through subgroups of
    one rank), ``devices=1, pipeline=True`` with two chunks a join (forced:
    the executor's default on one rank is one), and a split partition with
    ``devices=1``, over an NCCL group of size 1: each equals the one-device
    run on its partition, labels bitwise and every stat equal, and the
    scalar kernel runs on the rank's plan rows, once a pipeline chunk."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core import exec as exec_mod
    balance = "split" if mode == "split" else "hash"
    # hub-heavy for split (alpha 1.5): hot workers cut into several shards
    g = tgen.powerlaw(3000, avg_deg=8, seed=1, weighted=True,
                      alpha=1.5 if mode == "split" else 2.0).symmetrized()
    one = Engine(backend="pallas", layout="csr", balance=balance,
                 split_factor=1.1, device=cuda)
    pg = one.partition(g, 8, tau=20, seed=0)
    kw = {"devices": (1, 1) if mode == "mesh" else 1,
          "pipeline": mode == "pipeline"}
    monkeypatch.setattr(exec_mod, "_chunks_of",
                        lambda D, pipeline, chunks: 2 if pipeline else None)
    kinds = exec_mod.broadcast_plan_kinds("pallas", algo == "hashmin")
    runs = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        sharded = Engine(backend="pallas", layout="csr", balance=balance,
                         split_factor=1.1, device=cuda, **kw)
        for name, eng in (("one", one), ("sharded", sharded)):
            before = tkernel.segment_combine_blocks.launches
            res = eng.run(algo, pg)
            torch.cuda.synchronize()
            runs[name] = (res, tkernel.segment_combine_blocks.launches
                          - before)
        sg = exec_mod.shard(pg, kw["devices"], kinds, cuda,
                            pipeline=kw["pipeline"])
    finally:
        dist.destroy_process_group()
    (a, la), (b, lb) = runs["one"], runs["sharded"]
    assert b.n_supersteps == a.n_supersteps
    # values a chunk (or one launch unchunked) plus the hit counts; and
    # the mirror fan-out for Hash-Min
    per_ss = (2 if mode == "pipeline" else 1) + 1 + (algo == "hashmin")
    if mode == "pipeline":
        assert sg.plans[kinds[0]].n_chunks == 2
    if mode == "split":
        assert pg.M_phys > pg.M
    assert lb == per_ss * b.n_supersteps
    assert la == (3 if algo == "hashmin" else 2) * a.n_supersteps
    assert torch.equal(a.state, b.state)
    assert set(a.stats) == set(b.stats)
    for k in a.stats:
        np.testing.assert_array_equal(np.asarray(b.stats[k]),
                                      np.asarray(a.stats[k]))
    if mode == "mesh":
        assert b.sharded["inner_rounds"] or algo == "hashmin"


@pytest.mark.parametrize("mode", ["1d", "mesh", "pipeline", "split"])
def test_sharded_gcn_on_one_card_over_nccl(cuda, mode, monkeypatch):
    """GCN training on the sharded executor through an NCCL group of size
    1 (the 1-D mesh, the (1, 1) mesh, the two-chunk pipeline, a split
    partition) equals the one-device run on its partition: the loss
    history within rtol 2e-4 and atol 2e-5, the same vector kernel
    launches (a rank of one's plans are the one-device plans; several a
    join at this chunk size) and no scalar launch."""
    import datetime
    import torch.distributed as dist
    from repro_torch.core import exec as exec_mod
    from repro_torch.train.gcn import normalize_adjacency
    balance = "split" if mode == "split" else "hash"
    g = normalize_adjacency(tgen.powerlaw(
        3000, avg_deg=8, seed=1, alpha=1.5 if mode == "split" else 2.0
    ).symmetrized())
    kw = dict(feat_dim=32, hidden=64, n_classes=8, epochs=3, lr=1e-2)
    monkeypatch.setattr(tplan, "VEC_CHUNK_BYTES", 1 << 20)
    monkeypatch.setattr(exec_mod, "_chunks_of",
                        lambda D, pipeline, chunks: 2 if pipeline else None)
    one = Engine(backend="pallas", layout="csr", balance=balance,
                 split_factor=1.1, device=cuda)
    pg = one.partition(g, 8, tau=20, seed=0)
    runs = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        sharded = Engine(backend="pallas", layout="csr", balance=balance,
                         split_factor=1.1, device=cuda,
                         devices=(1, 1) if mode == "mesh" else 1,
                         pipeline=mode == "pipeline")
        for name, eng in (("one", one), ("sharded", sharded)):
            c = tkernel.segment_combine_blocks
            before = (c.launches, c.launches_vec)
            res = eng.run("gcn", pg, **kw)
            torch.cuda.synchronize()
            runs[name] = (res, c.launches - before[0],
                          c.launches_vec - before[1])
    finally:
        dist.destroy_process_group()
    (a, sa, va), (b, sb, vb) = runs["one"], runs["sharded"]
    assert sa == sb == 0 and va == vb > 8 * kw["epochs"]
    np.testing.assert_allclose(b.history, a.history, rtol=2e-4, atol=2e-5)
    assert b.history[-1] < b.history[0]
    for k, v in a.state.items():
        assert b.state[k].shape == v.shape and bool(
            torch.isfinite(b.state[k]).all()), k
    if mode == "split":
        assert pg.M_phys > pg.M


def test_device_plan_is_uploaded_once_per_card(cuda):
    """"cuda" and "cuda:<current>" name one card: one device copy of a
    plan, whichever name the caller used first."""
    g = tgen.powerlaw(500, avg_deg=8, seed=2).symmetrized()
    pg = Engine(backend="pallas", layout="csr", device=cuda).partition(
        g, 4, tau=20, seed=0)
    plan = tplan.get_plan(pg, "all")
    first = tplan.device_plan(plan, "cuda")
    assert tplan.device_plan(plan, pg.device) is first
    assert tplan.device_plan(plan, torch.device(
        "cuda", torch.cuda.current_device())) is first
    assert len(plan.device_cache) == 1


def test_kernel_mode_ref_sends_cuda_tensors_to_the_plain_version(cuda):
    vals, idx = _inputs("max", torch.int32, 64, 128, 50, seed=3)
    before = tkernel.segment_combine_blocks.launches
    try:
        tplan.set_kernel_mode("ref")
        out = tplan._combine_rows(vals.to(cuda), idx.to(cuda), "max", 128)
    finally:
        tplan.set_kernel_mode("auto")
    assert tkernel.segment_combine_blocks.launches == before
    np.testing.assert_array_equal(
        out.cpu().numpy(),
        segment_combine_blocks_ref(vals, idx, "max", 128).numpy())


# ---------------------------------------------------------------------------
# flash attention and the SSD chunk scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [64, 100, 257])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 5])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0), (False, 16)])
def test_flash_kernel_matches_plain(cuda, S, d, n_rep, causal, window):
    """float32 within 1e-5 of max|v| of the float64 plain version (the
    kernel sums in another order)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(S + d + n_rep)
    q = torch.from_numpy(rng.randn(2 * n_rep, S, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, S, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, S, d).astype(np.float32))
    before = fk.flash_attention_bhsd.launches
    got = fk.flash_attention_bhsd(q.to(cuda), k.to(cuda), v.to(cuda),
                                  causal=causal, window=window)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    want = flash_attention_ref(q.double(), k.double(), v.double(),
                               causal=causal, window=window)
    assert float((got.cpu().double() - want).abs().max()) <= (
        1e-5 * float(v.abs().max()))


def test_flash_kernel_bf16(cuda):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in [(10, 300, 64), (2, 300, 64),
                                      (2, 300, 64)])
    got = fk.flash_attention_bhsd(q, k, v, causal=True, window=64)
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                               window=64)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 2e-2


@pytest.mark.parametrize("S", [31, 64, 100, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0), (False, 100)])
def test_flash_kernel_at_head_dim_256(cuda, S, dtype, n_rep, causal, window):
    """d=256 (Gemma-3's heads: 32-query tiles, and in bfloat16 one staging
    tile that the K and V copies take turns in) against the float64 plain
    version on the same inputs: float32 within 1e-5 of max|v|, bfloat16
    within 2e-2, as at the other head dims."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(cuda).manual_seed(S + n_rep + window)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in [(2 * n_rep, S, 256), (2, S, 256), (2, S, 256)])
    before = fk.flash_attention_bhsd.launches
    got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    assert got.dtype == dtype
    want = flash_attention_ref(q.double(), k.double(), v.double(),
                               causal=causal, window=window)
    err = float((got.double() - want).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * float(v.abs().max())
    else:
        assert err < 2e-2


@pytest.mark.parametrize("S", [128, 200, 300])
@pytest.mark.parametrize("P,N", [(64, 16), (64, 128), (16, 8), (128, 128)])
@pytest.mark.parametrize("g,init", [(1, False), (2, True)])
def test_ssd_kernel_matches_plain(cuda, S, P, N, g, init):
    """y and the final state within 1e-4 of their max of the float64
    recurrence, chunk-multiple and ragged S, with groups and an initial
    state."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    rng = np.random.RandomState(S + P + N)
    b, h = 2, 4
    x = rng.randn(b, S, h, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, S, h) - 1.0)).astype(np.float32)
    A = (-np.exp(0.5 * rng.randn(h))).astype(np.float32)
    B = rng.randn(b, S, g, N).astype(np.float32)
    C = rng.randn(b, S, g, N).astype(np.float32)
    s0 = rng.randn(b, h, P, N).astype(np.float32) if init else None
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    init_t = None if s0 is None else torch.from_numpy(s0)
    before = sk.ssd_chunk_scan.launches
    y, st = sk.ssd_chunk_scan(*[a.to(cuda) for a in args], chunk=128,
                              init_state=None if init_t is None
                              else init_t.to(cuda))
    torch.cuda.synchronize()
    assert sk.ssd_chunk_scan.launches == before + 1
    y64, st64 = ssd_scan_ref_model(*[a.double() for a in args],
                                   None if init_t is None
                                   else init_t.double())
    for got, want in ((y, y64), (st, st64)):
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("BH,BKV,window", [(32, 4, 0), (50, 10, 1024),
                                           (50, 10, 0)])
def test_flash_kernel_at_a_mesh_rank_shape(cuda, BH, BKV, window):
    """A rank's launches on the (1, 2) serving mesh, B=2 x 1024 tokens at
    d=64: TinyLlama-1.1B's 16 query and 2 kv heads a rank, Hymba-1.5B's
    25 / 5 heads whole (window and global layers); float32 within 1e-5 of
    max|v| of the float64 plain version."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(BH + window)
    q = torch.from_numpy(rng.randn(BH, 1024, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(BKV, 1024, 64).astype(np.float32))
    v = torch.from_numpy(rng.randn(BKV, 1024, 64).astype(np.float32))
    got = fk.flash_attention_bhsd(q.to(cuda), k.to(cuda), v.to(cuda),
                                  causal=True, window=window)
    want = flash_attention_ref(q.double(), k.double(), v.double(),
                               causal=True, window=window)
    assert float((got.cpu().double() - want).abs().max()) <= (
        1e-5 * float(v.abs().max()))


def test_ssd_kernel_at_a_mesh_rank_shape(cuda):
    """Hymba-1.5B's 25 of 50 SSM heads a rank on the (1, 2) serving mesh,
    B=2 x 1024 tokens, P=64, N=16, chunk 128: y and the final state within
    1e-4 of their max of the float64 recurrence."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    rng = np.random.RandomState(25)
    b, S, h, P, N = 2, 1024, 25, 64, 16
    x = rng.randn(b, S, h, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, S, h) - 1.0)).astype(np.float32)
    A = (-np.exp(0.5 * rng.randn(h))).astype(np.float32)
    B = rng.randn(b, S, 1, N).astype(np.float32)
    C = rng.randn(b, S, 1, N).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y, st = sk.ssd_chunk_scan(*[a.to(cuda) for a in args], chunk=128)
    y64, st64 = ssd_scan_ref_model(*[a.double() for a in args], None)
    for got, want in ((y, y64), (st, st64)):
        err = float((got.cpu().double() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("S", [127, 128, 129, 2112])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 5])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0), (False, 100)])
def test_flash_kernel_at_tile_edges(cuda, S, d, n_rep, causal, window):
    """Lengths one short of, at and one past the query tile, a long ragged
    one, and a window (100) that is no multiple of the tiles: float32
    within 1e-5 of max|v| of the float64 plain version."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(cuda).manual_seed(S + d + n_rep + window)
    q = torch.randn((2 * n_rep, S, d), generator=gen, device=cuda)
    k = torch.randn((2, S, d), generator=gen, device=cuda)
    v = torch.randn((2, S, d), generator=gen, device=cuda)
    before = fk.flash_attention_bhsd.launches
    got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    want = flash_attention_ref(q.double(), k.double(), v.double(),
                               causal=causal, window=window)
    assert float((got.double() - want).abs().max()) <= (
        1e-5 * float(v.abs().max()))


@pytest.mark.parametrize("Sq,Sk", [(1, 1500), (384, 1500), (1600, 1500),
                                   (37, 100), (37, 16), (1500, 1500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_unmasked_rectangular(cuda, Sq, Sk, dtype):
    """Cross-attention's shapes (no mask, Sq != Sk, Sq > Sk among them,
    Whisper's 1500 frames and a decode step's one query): float32 within
    1e-5 of max|v| of the float64 plain version, bfloat16 within 2e-2."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(cuda).manual_seed(Sq + Sk)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in [(4, Sq, 64), (2, Sk, 64), (2, Sk, 64)])
    before = fk.flash_attention_bhsd.launches
    got = fk.flash_attention_bhsd(q, k, v, causal=False, window=0)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    assert got.shape == (4, Sq, 64) and got.dtype == dtype
    want = flash_attention_ref(q.double(), k.double(), v.double(),
                               causal=False, window=0)
    err = float((got.double() - want).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * float(v.abs().max())
    else:
        assert err <= 2e-2
    if Sq > Sk:
        for causal, window in ((True, 0), (False, 16)):
            with pytest.raises(ValueError, match="Sq <= Sk"):
                fk.launch(q, k, v, causal=causal, window=window)


def test_flash_kernel_takes_unaligned_kv(cuda):
    """k and v that start 4 bytes past a 16-byte boundary (views into a
    larger buffer) give the same output as aligned copies."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(cuda).manual_seed(3)
    q = torch.randn((4, 100, 64), generator=gen, device=cuda)
    buf = torch.randn(2 * 2 * 100 * 64 + 1, generator=gen, device=cuda)
    k = buf[1:1 + 2 * 100 * 64].view(2, 100, 64)
    v = buf[1 + 2 * 100 * 64:].view(2, 100, 64)
    assert k.data_ptr() % 16 and k.is_contiguous()
    got = fk.launch(q, k, v, causal=True, window=0)
    want = fk.launch(q, k.clone(), v.clone(), causal=True, window=0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 1024])
def test_flash_kernel_is_deterministic(cuda, dtype, window):
    """Two launches on the same inputs (the path's shapes: 25 query heads
    over 5 kv heads, S=2048, d=64) give the same output, bit for bit."""
    from repro_torch.kernels.flash_attention import kernel as fk
    gen = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in [(25, 2048, 64), (5, 2048, 64), (5, 2048, 64)])
    a = fk.launch(q, k, v, causal=True, window=window)
    b = fk.launch(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("S", [2048, 2112])
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_kernel_at_path_lengths(cuda, S, chunk, init):
    """The path's P=64, N=16 at S a multiple of both chunks and ragged,
    with and without an initial state: y and the final state within 1e-4
    of their max of the float64 recurrence."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    gen = torch.Generator(cuda).manual_seed(S + chunk)
    b, h, P, N = 2, 4, 64, 16
    x = torch.randn((b, S, h, P), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((b, S, h), generator=gen, device=cuda) - 1.0)
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device=cuda))
    B = torch.randn((b, S, 1, N), generator=gen, device=cuda)
    C = torch.randn((b, S, 1, N), generator=gen, device=cuda)
    s0 = (torch.randn((b, h, P, N), generator=gen, device=cuda) if init
          else None)
    before = sk.ssd_chunk_scan.launches
    y, st = sk.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert sk.ssd_chunk_scan.launches == before + 1
    y64, st64 = ssd_scan_ref_model(x.double(), dt.double(), A.double(),
                                   B.double(), C.double(),
                                   None if s0 is None else s0.double())
    for got, want in ((y, y64), (st, st64)):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("P,N,g", [(64, 16, 1), (128, 128, 2), (24, 12, 2)])
def test_ssd_kernel_is_deterministic(cuda, P, N, g):
    """Two launches on the same inputs give the same y and final state,
    bit for bit."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    gen = torch.Generator(cuda).manual_seed(P + N)
    b, h, S = 2, 4, 300
    x = torch.randn((b, S, h, P), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((b, S, h), generator=gen, device=cuda))
    A = -torch.rand((h,), generator=gen, device=cuda) - 0.1
    B = torch.randn((b, S, g, N), generator=gen, device=cuda)
    C = torch.randn((b, S, g, N), generator=gen, device=cuda)
    s0 = torch.randn((b, h, P, N), generator=gen, device=cuda)
    y1, st1 = sk.launch(x, dt, A, B, C, chunk=128, init_state=s0)
    y2, st2 = sk.launch(x, dt, A, B, C, chunk=128, init_state=s0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(st1, st2)


def test_lm_entry_points_refuse_a_bad_geometry(cuda):
    """The flash and SSD C entry points check the launch shape the wrappers'
    ``launch_geometry`` gives them and return cudaErrorInvalidValue (1) on
    any other value."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    dev = cuda.index or 0
    stream = torch.cuda.current_stream().cuda_stream
    for d in fk.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q = torch.randn(2, 64, d, device=cuda).to(dtype)
            out = torch.empty_like(q)
            geo = fk.launch_geometry(d, dtype, 2, 64)
            args = [q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
                    2, 64, 64, d, 1, fk._DTYPES[dtype], 1, 0, d ** -0.5]
            good = [geo.threads, geo.q_tile, geo.k_tile, geo.smem_bytes]
            lib = fk._library()
            assert lib.flash_attention_launch(*args, *good, dev, stream) == 0
            for i, delta in ((0, 32), (1, 16), (2, 32), (3, 16), (3, -16)):
                bad = list(good)
                bad[i] += delta
                assert lib.flash_attention_launch(*args, *bad, dev,
                                                  stream) == 1
    b, S, h, g = 1, 200, 2, 1
    for P, N, Q in ((64, 16, 128), (64, 128, 64), (17, 3, 33), (128, 1, 1)):
        x = torch.randn(b, S, h, P, device=cuda)
        dt = torch.rand(b, S, h, device=cuda)
        A = -torch.rand(h, device=cuda)
        B = torch.randn(b, S, g, N, device=cuda)
        nc = -(-S // Q)
        y = torch.empty_like(x)
        st = torch.empty(b, h, P, N, device=cuda)
        cs = torch.empty(b, h, nc, P, N, device=cuda)
        cd = torch.empty(b, h, nc, device=cuda)
        args = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                B.data_ptr(), None, y.data_ptr(), st.data_ptr(),
                cs.data_ptr(), cd.data_ptr(), b, S, h, g, P, N, Q, 0]
        geo = sk.launch_geometry(P, N, Q)
        good = [geo.state_threads, geo.threads, geo.pass_threads, geo.p_tile,
                geo.state_smem, geo.scan_smem]
        lib = sk._library()
        assert lib.ssd_scan_launch(*args, *good, dev, stream) == 0
        for i in range(len(good)):
            for delta in (-16, 16):
                bad = list(good)
                bad[i] += delta
                assert lib.ssd_scan_launch(*args, *bad, dev, stream) == 1
    torch.cuda.synchronize()


def test_lm_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    q = torch.randn(4, 64, 64, device=cuda)
    k = torch.randn(2, 64, 64, device=cuda)
    with pytest.raises(TypeError):
        fk.launch(q.half(), k, k)           # one type for q, k and v
    with pytest.raises(TypeError):
        fk.launch(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="head dim"):
        fk.launch(q[..., :48].contiguous(), k[..., :48].contiguous(),
                  k[..., :48].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        fk.launch(q.cpu(), k.cpu(), k.cpu())
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fk.launch(q, k[:, :32].contiguous(), k[:, :32].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        fk.launch(q[:3].contiguous(), k, k)
    x = torch.randn(1, 16, 4, 64, device=cuda)
    dt = torch.rand(1, 16, 4, device=cuda)
    A = -torch.rand(4, device=cuda)
    B = torch.randn(1, 16, 1, 16, device=cuda)
    with pytest.raises(TypeError):
        sk.launch(x.double(), dt, A, B, B, chunk=128)
    with pytest.raises(TypeError):       # x, B, C of one type at the launch
        sk.launch(x.half(), dt, A, B, B, chunk=128)
    with pytest.raises(TypeError):       # dt, A float32 at the launch
        sk.launch(x, dt.half(), A, B, B, chunk=128)
    with pytest.raises(ValueError, match="CUDA"):
        sk.launch(x.cpu(), dt, A, B, B, chunk=128)
    with pytest.raises(ValueError, match="state dim"):
        big = torch.randn(1, 16, 1, 256, device=cuda)
        sk.launch(x, dt, A, big, big, chunk=128)
    with pytest.raises(ValueError, match="chunk"):
        sk.launch(x, dt, A, B, B, chunk=256)


def test_gemma3_model_kernels_against_plain(cuda):
    """A small Gemma-3 (head dim 256, tied embeddings; window, global and
    window layers; a prompt longer than the window): prefill through the
    flash kernel (one launch a layer) against the plain path, then four
    decode steps, each within 1e-4 of max|logit|."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import ModelContext
    cfg = dataclasses.replace(get_config("gemma3_4b").reduced(), n_layers=4,
                              global_every=3, vocab=250, head_dim=256)
    params = zoo.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 41)).astype(np.int32)).to(cuda)
    out, fed = {}, []
    for mode in ("ref", "auto"):
        ctx = ModelContext(q_chunk=64, kernels=mode)
        before = fk.flash_attention_bhsd.launches
        logits, cache = zoo.prefill(params, cfg, ctx, toks, max_len=45)
        assert fk.flash_attention_bhsd.launches - before == (
            4 if mode == "auto" else 0)
        steps = [logits]
        for i in range(4):
            if mode == "ref":
                fed.append(zoo.greedy(logits))
            logits, cache = zoo.decode_step(params, cfg, ctx, fed[i], cache)
            steps.append(logits)
        out[mode] = torch.stack(steps)[..., :cfg.vocab]
    scale = float(out["ref"].abs().max())
    assert float((out["auto"] - out["ref"]).abs().max()) <= 1e-4 * scale


def test_whisper_model_kernels_against_plain(cuda):
    """A small Whisper (2 encoder and 2 decoder layers at d=64, 100 frames,
    a prompt of 120 tokens: longer than the frames, so the cross-attention
    has Sq > Sk): prefill through the flash kernel (one launch an encoder
    layer, two a decoder layer: self and cross) and four decode steps (one
    cross launch a decoder layer) against the plain path, each within 1e-4
    of max|logit|."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import ModelContext
    cfg = dataclasses.replace(get_config("whisper_medium").reduced(),
                              vocab=250, head_dim=64, enc_seq=100)
    params = zoo.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 120)).astype(
        np.int32)).to(cuda)
    enc = torch.from_numpy(rng.randn(2, cfg.enc_seq, cfg.d_model).astype(
        np.float32)).to(cuda)
    out, fed = {}, []
    for mode in ("ref", "auto"):
        ctx = ModelContext(q_chunk=128, kernels=mode)
        on = mode == "auto"
        before = fk.flash_attention_bhsd.launches
        logits, cache = zoo.prefill(params, cfg, ctx, toks, enc_embeds=enc,
                                    max_len=124)
        assert fk.flash_attention_bhsd.launches - before == (
            cfg.n_enc_layers + 2 * cfg.n_layers if on else 0)
        steps = [logits]
        for i in range(4):
            if mode == "ref":
                fed.append(zoo.greedy(logits))
            before = fk.flash_attention_bhsd.launches
            logits, cache = zoo.decode_step(params, cfg, ctx, fed[i], cache)
            assert fk.flash_attention_bhsd.launches - before == (
                cfg.n_layers if on else 0)
            steps.append(logits)
        out[mode] = torch.stack(steps)[..., :cfg.vocab]
    scale = float(out["ref"].abs().max())
    assert float((out["auto"] - out["ref"]).abs().max()) <= 1e-4 * scale


def test_hybrid_model_kernels_against_plain(cuda):
    """A small hybrid model (window, global and window layers; a prompt
    longer than the window and not a multiple of the chunk) on the card:
    prefill through both kernels (one launch each a layer) against the
    plain path, then four decode steps against the plain path's, each
    within 1e-4 of max|logit|."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import ModelContext
    cfg = dataclasses.replace(get_config("hymba_1_5b").reduced(), n_layers=4,
                              global_every=3, vocab=250, head_dim=64)
    params = zoo.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 41)).astype(np.int32)).to(cuda)
    out, fed = {}, []
    for mode in ("ref", "auto"):          # both decode the plain path's tokens
        ctx = ModelContext(q_chunk=64, kernels=mode)
        before = (fk.flash_attention_bhsd.launches,
                  sk.ssd_chunk_scan.launches)
        logits, cache = zoo.prefill(params, cfg, ctx, toks, max_len=45)
        launches = (fk.flash_attention_bhsd.launches - before[0],
                    sk.ssd_chunk_scan.launches - before[1])
        assert launches == ((4, 4) if mode == "auto" else (0, 0))
        steps = [logits]
        for i in range(4):
            if mode == "ref":
                fed.append(zoo.greedy(logits))
            logits, cache = zoo.decode_step(params, cfg, ctx, fed[i], cache)
            steps.append(logits)
        out[mode] = torch.stack(steps)[..., :cfg.vocab]
    scale = float(out["ref"].abs().max())
    assert float((out["auto"] - out["ref"]).abs().max()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# half types, the autograd Functions, a train step
# ---------------------------------------------------------------------------

def _half_bound(want, dtype, vmax):
    """One rounding of the half output (an ulp at each value) on top of
    float32's 1e-5 of max|v|."""
    mant = {torch.float16: 10, torch.bfloat16: 7}[dtype]
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(
        min=torch.finfo(dtype).tiny))) - mant)
    return ulp + 1e-5 * vmax


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (100, 100, True, 0), (257, 257, True, 16), (64, 64, False, 0),
    (300, 100, False, 0), (1, 300, False, 0)])
def test_flash_kernel_float16(cuda, d, Sq, Sk, causal, window):
    """float16 at every head dim (the staging of bfloat16, one tile at
    d = 256), causal, windowed, unmasked and unmasked with Sq > Sk,
    against the float64 plain version on the same (float16) inputs."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(cuda).manual_seed(d + Sq)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).half()
               for shape in [(4, Sq, d), (2, Sk, d), (2, Sk, d)])
    before = fk.flash_attention_bhsd.launches
    got = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    assert got.dtype == torch.float16
    want = flash_attention_ref(q.double(), k.double(), v.double(),
                               causal=causal, window=window)
    bound = _half_bound(want, torch.float16, float(v.abs().max()))
    assert ((got.double() - want).abs() <= bound).all()


@pytest.mark.parametrize("xt,bt", [(torch.float16, torch.float16),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float16, torch.bfloat16)])
@pytest.mark.parametrize("S,P,N,g", [(256, 64, 16, 1), (200, 17, 3, 2)])
def test_ssd_kernel_half_inputs(cuda, xt, bt, S, P, N, g):
    """x, B, C in half types (and mixed: the wrapper widens a mix to
    float32 and rounds y once), dt and A in float32: y in x's type within
    one of its ulps plus 1e-4 of max|y| of the float64 recurrence, the
    final state (float32) within 1e-4 of its max."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    gen = torch.Generator(cuda).manual_seed(S + P)
    b, h = 2, 4
    x = torch.randn(b, S, h, P, generator=gen, device=cuda).to(xt)
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, h, generator=gen, device=cuda))
    A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=cuda))
    B, C = (torch.randn(b, S, g, N, generator=gen, device=cuda).to(bt)
            for _ in range(2))
    before = sk.ssd_chunk_scan.launches
    y, st = sk.ssd_chunk_scan(x, dt, A, B, C, chunk=128)
    torch.cuda.synchronize()
    assert sk.ssd_chunk_scan.launches == before + 1
    assert y.dtype == xt and st.dtype == torch.float32
    y64, st64 = ssd_scan_ref_model(x.double(), dt.double(), A.double(),
                                   B.double(), C.double())
    mant = {torch.float16: 10, torch.bfloat16: 7}[xt]
    ulp = torch.exp2(torch.floor(torch.log2(y64.abs().clamp(
        min=torch.finfo(xt).tiny))) - mant)
    assert ((y.double() - y64).abs() <= ulp + 1e-4 * y64.abs().max()).all()
    assert float((st.double() - st64).abs().max()) <= \
        1e-4 * float(st64.abs().max())


@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 300, 300), (True, 64, 300, 300), (False, 0, 200, 300)])
def test_flash_function_grads_on_the_card(cuda, causal, window, Sq, Sk):
    """The Function's o, dq, dk, dv (kernel forward, chunked plain
    backward) against float64 autograd of the plain version, within 4x
    the float32 plain path's own error (and 1e-6 of the max); one kernel
    launch a forward, none in the backward; the output carries the
    Function's grad_fn."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(cuda).manual_seed(Sq + window)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in [(8, Sq, 64), (2, Sk, 64), (2, Sk, 64)])
    do = torch.randn(8, Sq, 64, generator=gen, device=cuda)

    def run(fn, dtype):
        ts = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        o = fn(*ts, causal=causal, window=window)
        return [o] + list(torch.autograd.grad(o, ts, do.to(dtype)))
    before = fk.flash_attention_bhsd.launches
    got = run(fk.flash_attention_bhsd, torch.float32)
    torch.cuda.synchronize()
    assert fk.flash_attention_bhsd.launches == before + 1
    want = run(flash_attention_ref, torch.float64)
    plain = run(flash_attention_ref, torch.float32)
    for g, w, p in zip(got, want, plain):
        own = float((p.double() - w).abs().max())
        err = float((g.double() - w).abs().max())
        assert err <= 4.0 * own + 1e-6 * float(w.abs().max()), (err, own)
    o = fk.flash_attention_bhsd(q.requires_grad_(True), k, v, causal=causal,
                                window=window)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"


def test_ssd_function_grads_on_the_card(cuda):
    """The SSD Function's dx, ddt, dA, dB, dC (kernel forward, backward
    through ``ssd_chunked``) against float64 autograd of ``ssd_chunked``,
    within 4x the float32 path's own error; one call a forward."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.models.ssm import ssd_chunked
    gen = torch.Generator(cuda).manual_seed(0)
    b, S, h, P, g, N = 2, 256, 4, 64, 1, 16
    x = torch.randn(b, S, h, P, generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, h, generator=gen, device=cuda))
    A = -torch.exp(0.5 * torch.randn(h, generator=gen, device=cuda))
    B, C = (torch.randn(b, S, g, N, generator=gen, device=cuda)
            for _ in range(2))
    dy = torch.randn(b, S, h, P, generator=gen, device=cuda)

    def run(fn, dtype):
        ts = [t.to(dtype).requires_grad_(True) for t in (x, dt, A, B, C)]
        y = fn(*ts)
        return [y] + list(torch.autograd.grad(y, ts, dy.to(dtype)))
    before = sk.ssd_chunk_scan.launches
    got = run(lambda *a: sk.ssd_chunk_scan(*a, chunk=128)[0], torch.float32)
    torch.cuda.synchronize()
    assert sk.ssd_chunk_scan.launches == before + 1
    want = run(lambda *a: ssd_chunked(*a, 128)[0], torch.float64)
    plain = run(lambda *a: ssd_chunked(*a, 128)[0], torch.float32)
    for gg, w, p in zip(got, want, plain):
        own = float((p.double() - w).abs().max())
        err = float((gg.double() - w).abs().max())
        assert err <= 4.0 * own + 1e-6 * float(w.abs().max()), (err, own)


def test_train_step_through_the_kernels(cuda):
    """A reduced TinyLlama and Hymba train step on the card: the loss and
    every leaf's gradient with the kernels (under "full" recomputation)
    against the plain path ("ref"), within 1e-4 of each leaf's max; the
    flash launches a step (2 a layer: the forward and the recomputed
    forward), and no leaf left without a gradient."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import ModelContext
    from repro_torch.train.optimizer import tree_leaves, tree_map
    from repro_torch.train.train_step import init_train_state
    for arch in ("tinyllama_1_1b", "hymba_1_5b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), vocab=250)
        params = init_train_state(cfg, torch.Generator(cuda).manual_seed(0),
                                  cuda)["params"]
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, 250, (2, 64)).astype(np.int32)).to(cuda)
        out = {}
        for mode in ("auto", "ref"):
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            before = fk.flash_attention_bhsd.launches
            loss, _ = zoo.loss_fn(p, cfg, ModelContext(
                q_chunk=64, kernels=mode, remat="full"), {"tokens": toks})
            grads = torch.autograd.grad(loss, tree_leaves(p))
            torch.cuda.synchronize()
            out[mode] = (loss, grads, fk.flash_attention_bhsd.launches - before)
        assert out["auto"][2] == 2 * cfg.n_layers and out["ref"][2] == 0
        assert abs(float(out["auto"][0] - out["ref"][0])) <= \
            1e-5 * float(out["ref"][0])
        for a, b in zip(out["auto"][1], out["ref"][1]):
            assert float(b.abs().max()) > 0
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
