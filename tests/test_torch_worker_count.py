"""The per-worker tally behind every ``per_worker_*`` statistic
(``plan.per_worker``): the worker_count kernel's plain version against a
numpy ``np.add.at`` tally, its launch geometry against the card's limits,
and, on the card (``cuda`` marker), the kernel bit-equal to the plain
version, free of host syncs, and Hash-Min's and S-V's statistics on the
card equal to the CPU run's with the kernel launched 3 and 13 times a
superstep.

The file imports no JAX; its card tests run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_worker_count.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels.worker_count import kernel as wk  # noqa: E402
from repro_torch.kernels.worker_count.ref import worker_count_ref  # noqa: E402

COUNT_DTYPES = [torch.bool, torch.int32, torch.int64]
ID_DTYPES = [torch.int32, torch.int64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _tally(worker: np.ndarray, counts: np.ndarray, M: int) -> np.ndarray:
    out = np.zeros(M, np.int64)
    keep = (worker >= 0) & (worker < M)
    np.add.at(out, worker[keep], counts[keep].astype(np.int64))
    return out


def _counts(rng, n: int, dtype: torch.dtype) -> np.ndarray:
    if dtype == torch.bool:
        return rng.rand(n) < 0.4
    hi = 1000 if dtype == torch.int32 else 2 ** 40
    c = rng.randint(-hi, hi, n, dtype=np.int64)
    c[rng.rand(n) < 0.3] = 0
    return c.astype(np.int32 if dtype == torch.int32 else np.int64)


def _inputs(kind: str, n: int, M: int, id_dtype, count_dtype, seed: int):
    """ids shaped like the channels' inputs: ``sorted`` runs like csr edge
    owners, ``random`` ids like Ch_req owners, ``one`` worker holding every
    lane; each with some ids outside [0, M)."""
    rng = np.random.RandomState(seed)
    if kind == "sorted":
        sizes = rng.multinomial(n, rng.dirichlet(np.ones(M)))
        ids = np.repeat(np.arange(M), sizes)
    elif kind == "random":
        ids = rng.randint(-2, M + 3, n)
    else:
        ids = np.full(n, M // 2)
    ids = ids.astype(np.int32 if id_dtype == torch.int32 else np.int64)
    return ids, _counts(rng, n, count_dtype)


@pytest.mark.parametrize("M", [1, 32, 33])
@pytest.mark.parametrize("id_dtype", ID_DTYPES)
@pytest.mark.parametrize("count_dtype", COUNT_DTYPES)
@pytest.mark.parametrize("kind", ["sorted", "random"])
def test_plain_matches_numpy_tally(kind, count_dtype, id_dtype, M):
    ids, counts = _inputs(kind, 5000, M, id_dtype, count_dtype, seed=M)
    if kind == "sorted":
        ids[:7] = [-1, M, M + 1, -5, M, 0, M - 1]   # at and beyond M
    got = worker_count_ref(torch.from_numpy(ids), torch.from_numpy(counts),
                           M)
    assert got.dtype == torch.int64 and got.shape == (M,)
    np.testing.assert_array_equal(got.numpy(), _tally(ids, counts, M))


@pytest.mark.parametrize("count_dtype", COUNT_DTYPES)
def test_plain_empty_input_gives_zeros(count_dtype):
    got = worker_count_ref(torch.zeros(0, dtype=torch.int64),
                           torch.zeros(0, dtype=count_dtype), 5)
    np.testing.assert_array_equal(got.numpy(), np.zeros(5, np.int64))


def test_plain_int64_totals_are_exact_beyond_2_53():
    """Integer counts sum in int64: no float64 rounding above 2^53."""
    counts = torch.tensor([2 ** 53, 1, 1, 2 ** 60, 3], dtype=torch.int64)
    worker = torch.tensor([0, 0, 0, 1, 1])
    got = tplan.per_worker(worker, counts, 2)
    assert got.tolist() == [2 ** 53 + 2, 2 ** 60 + 3]


def test_plain_rejects_what_it_does_not_take():
    """The plain version takes the kernel's dtypes and no others, so a
    caller that the CPU tests run hands the card nothing it refuses."""
    w = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        worker_count_ref(w, torch.ones(4), 2)
    with pytest.raises(TypeError):
        worker_count_ref(torch.zeros(4), torch.ones(4, dtype=torch.bool), 2)
    with pytest.raises(TypeError):
        worker_count_ref(w.to(torch.int16), torch.ones(4, dtype=torch.bool),
                         2)
    with pytest.raises(TypeError):
        worker_count_ref(w, torch.ones(4, dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        worker_count_ref(w, torch.ones(5, dtype=torch.bool), 2)


def test_per_worker_on_the_cpu_takes_the_plain_version():
    """A CPU tensor never reaches the kernel: the launch count stays."""
    ids, counts = _inputs("random", 1000, 8, torch.int64, torch.bool, 0)
    before = wk.launches()
    got = tplan.per_worker(torch.from_numpy(ids), torch.from_numpy(counts), 8)
    assert wk.launches() == before
    np.testing.assert_array_equal(got.numpy(), _tally(ids, counts, 8))


N_ALL = sorted({0, 1, 2, 3, 4, 5, 7, 255, 1023, 1024, 1025, 4095, 4096,
                4097, 65_537, 1_000_003, 6_007_006, 42_850_000, 10 ** 8})


def _within_limits(geo, n, M, id_bytes, aligned):
    vec = 16 // id_bytes if aligned else 1
    n_vec = n // vec
    assert geo.vec == vec and geo.vec * id_bytes <= wk.MAX_LOAD
    assert geo.smem_bytes == 8 * M <= wk.SMEM_DEFAULT
    assert 1 <= geo.blocks <= min(2 ** 31 - 1, 132 * wk.BLOCKS_PER_SM)
    # the chunks cover every whole vector, and the C entry point's check
    assert geo.chunk == -(-n_vec // geo.blocks)
    assert geo.blocks * geo.chunk >= n_vec
    # the ids past the last whole vector fit the last block's threads
    assert n - n_vec * vec < vec <= wk.THREADS
    # no block is given less than one full step of loads, bar the only one
    assert geo.blocks == 1 or geo.chunk >= wk.THREADS * wk.UNROLL // 2


@pytest.mark.parametrize("id_bytes", [4, 8])
@pytest.mark.parametrize("aligned", [True, False])
def test_geometry_within_the_card_limits(id_bytes, aligned):
    for M in list(range(1, 130)) + [255, 256, 1000, 4096, wk.MAX_M - 1,
                                    wk.MAX_M]:
        for n in N_ALL:
            geo = wk.launch_geometry(n, M, id_bytes, aligned)
            _within_limits(geo, n, M, id_bytes, aligned)


def test_geometry_raises_beyond_its_bounds():
    assert wk.MAX_M == 6144
    for M in (0, -1, wk.MAX_M + 1, 10 ** 6):
        with pytest.raises(ValueError):
            wk.launch_geometry(10, M)
    with pytest.raises(ValueError):
        wk.launch_geometry(-1, 4)


def test_geometry_on_a_smaller_card():
    geo = wk.launch_geometry(10 ** 8, 32, 8, True, n_sm=16)
    assert geo.blocks == 16 * wk.BLOCKS_PER_SM


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("count_dtype", COUNT_DTYPES)
@pytest.mark.parametrize("id_dtype", ID_DTYPES)
@pytest.mark.parametrize("kind,n,M", [
    ("sorted", 6_007_006, 32), ("sorted", 1_000_003, 33),
    ("random", 1_000_003, 32), ("random", 77, 6144), ("one", 65_537, 32),
    ("sorted", 5, 1), ("random", 4097, 256)])
def test_kernel_bit_equal_to_plain(cuda, kind, n, M, id_dtype, count_dtype):
    ids, counts = _inputs(kind, n, M, id_dtype, count_dtype, seed=n % 97)
    w, c = torch.from_numpy(ids), torch.from_numpy(counts)
    before = wk.launches()
    got = wk.worker_count(w.to(cuda), c.to(cuda), M)
    again = wk.worker_count(w.to(cuda), c.to(cuda), M)
    torch.cuda.synchronize()
    assert wk.launches() == before + 2
    want = worker_count_ref(w, c, M)
    assert torch.equal(got.cpu(), want) and torch.equal(again.cpu(), want)
    np.testing.assert_array_equal(want.numpy(), _tally(ids, counts, M))


@pytest.mark.cuda
@pytest.mark.parametrize("count_dtype", COUNT_DTYPES)
@pytest.mark.parametrize("id_dtype", ID_DTYPES)
@pytest.mark.parametrize("offset", [1, 3, 5])
def test_kernel_on_an_unaligned_view(cuda, offset, id_dtype, count_dtype):
    """A sliced view whose addresses do not allow the vector loads takes
    one id a load and gives the same totals.  (An odd offset leaves the
    ids off 16 bytes for both id dtypes; an even one of int64 ids lands
    on 16.)"""
    ids, counts = _inputs("sorted", 100_003, 32, id_dtype, count_dtype, 5)
    w, c = torch.from_numpy(ids), torch.from_numpy(counts)
    wd, cd = w.to(cuda)[offset:], c.to(cuda)[offset:]
    assert not wk._aligned(wd, cd)
    got = wk.worker_count(wd, cd, 32)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), worker_count_ref(w[offset:], c[offset:],
                                                   32))


@pytest.mark.cuda
def test_kernel_empty_input_and_bounds(cuda):
    before = wk.launches()
    got = wk.worker_count(torch.zeros(0, dtype=torch.int64, device=cuda),
                          torch.zeros(0, dtype=torch.bool, device=cuda), 7)
    assert wk.launches() == before
    assert torch.equal(got.cpu(), torch.zeros(7, dtype=torch.int64))
    w = torch.zeros(10, dtype=torch.int64, device=cuda)
    c = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        wk.worker_count(w, c, wk.MAX_M + 1)
    with pytest.raises(TypeError):
        wk.worker_count(w, c.to(torch.int16), 4)
    with pytest.raises(TypeError):
        wk.worker_count(w.to(torch.int16), c, 4)


@pytest.mark.cuda
def test_entry_point_refuses_a_bad_geometry(cuda):
    """The C entry point checks the geometry again and returns
    cudaErrorInvalidValue (1) on a value the kernel does not take."""
    n, M = 10_000, 32
    w = torch.zeros(n, dtype=torch.int64, device=cuda)
    c = torch.ones(n, dtype=torch.bool, device=cuda)
    geo = wk.launch_geometry(n, M, 8, True, wk._sm_count(cuda))
    part = torch.empty((geo.blocks, M), dtype=torch.int64, device=cuda)
    out = torch.empty(M, dtype=torch.int64, device=cuda)
    lib = wk._library()
    stream = torch.cuda.current_stream().cuda_stream
    good = (geo.vec, geo.smem_bytes, geo.blocks, geo.chunk)

    def call(ids_ptr, M_, vec, smem, blocks, chunk, id_type=1):
        return lib.worker_count_launch(ids_ptr, c.data_ptr(), part.data_ptr(),
                                       out.data_ptr(), n, M_, id_type, 0, vec,
                                       smem, blocks, chunk, cuda.index or 0,
                                       stream)

    assert call(w.data_ptr(), M, *good) == 0
    torch.cuda.synchronize()
    assert out.cpu().tolist() == [n] + [0] * (M - 1)
    for bad in [(M, 4, *good[1:]), (M, good[0], 8 * M + 8, *good[2:]),
                (M, *good[:2], 0, good[3]), (M, *good[:3], good[3] + 1),
                (0, *good), (wk.MAX_M + 1, *good)]:
        assert call(w.data_ptr(), *bad) == 1
    assert call(w.data_ptr() + 8, M, *good) == 1      # 16-byte loads
    assert call(w.data_ptr(), M, *good, id_type=0) == 1   # vec 2 of int32
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_per_worker_issues_no_host_sync(cuda):
    """Under torch's sync debug mode "error" a host sync raises: the kernel
    path of ``plan.per_worker`` has none."""
    inputs = []
    for id_dtype in ID_DTYPES:
        for count_dtype in COUNT_DTYPES:
            ids, counts = _inputs("random", 50_001, 32, id_dtype,
                                  count_dtype, 3)
            inputs.append((torch.from_numpy(ids).to(cuda),
                           torch.from_numpy(counts).to(cuda)))
    tplan.per_worker(*inputs[0], 32)          # builds and loads the library
    torch.cuda.synchronize()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for w, c in inputs:
            outs.append(tplan.per_worker(w, c, 32))
            outs.append(tplan.per_worker(w[1:], c[1:], 32))
        outs.append(tplan.per_worker(inputs[0][0][:0], inputs[0][1][:0], 32))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for (w, c), out, part in zip(inputs, outs[0:-1:2], outs[1:-1:2]):
        assert torch.equal(out.cpu(), worker_count_ref(w.cpu(), c.cpu(), 32))
        assert torch.equal(part.cpu(), worker_count_ref(w[1:].cpu(),
                                                        c[1:].cpu(), 32))
    assert torch.equal(outs[-1].cpu(), torch.zeros(32, dtype=torch.int64))


def _cell_run(algo: str, g, device):
    from repro_torch.api import Engine
    from repro_torch.core import cost_model
    deg = np.bincount(g.src, minlength=g.n)
    eng = Engine(backend="pallas", layout="csr", balance="hash",
                 device=device)
    pg = eng.partition(g, 32, tau=cost_model.choose_tau(deg, 32), seed=0)
    before = wk.launches()
    res = eng.run(algo, pg)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return res, wk.launches() - before


@pytest.mark.cuda
@pytest.mark.parametrize("algo,per_step", [("hashmin", 3), ("sv", 13)])
def test_cell_statistics_on_the_card(cuda, algo, per_step):
    """Hash-Min and S-V at 200k vertices, M = 32, in the benchmark cells'
    engine configuration: every msgs_* and per_worker_* statistic on the
    card equals the CPU run's, and the kernel runs 3 (Hash-Min) and 13
    (S-V) times a superstep."""
    from repro_torch.graph import generators as tgen
    g = (tgen.powerlaw(200_000, avg_deg=16, seed=1).symmetrized()
         if algo == "hashmin" else tgen.grid_road(448, seed=1))
    res, launches = _cell_run(algo, g, cuda)
    ref, cpu_launches = _cell_run(algo, g, "cpu")
    assert cpu_launches == 0
    assert launches == per_step * res.n_supersteps
    assert res.n_supersteps == ref.n_supersteps
    keys = [k for k in ref.stats if k.startswith(("msgs_", "per_worker_"))]
    assert sorted(keys) == sorted(k for k in res.stats
                                  if k.startswith(("msgs_", "per_worker_")))
    for k in keys:
        np.testing.assert_array_equal(np.asarray(res.stats[k]),
                                      np.asarray(ref.stats[k]), err_msg=k)
