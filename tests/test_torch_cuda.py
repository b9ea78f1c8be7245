"""The port on the card: the CUDA segment_combine kernels (scalar and
vector) against their plain PyTorch version, and the main paths on a small
graph (the algorithms, GCN training) with the kernels against the dense
backend.

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
    with pytest.raises(NotImplementedError):
        tkernel.launch(v.to(torch.bfloat16), i, "min", 32)
    with pytest.raises(NotImplementedError):
        tkernel.launch_vec(v[..., None].to(torch.float16), i, "min", 32)
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
