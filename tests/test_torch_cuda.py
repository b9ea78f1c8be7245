"""The port on the card: the CUDA segment_combine kernels (scalar and
vector), the flash attention kernel and the SSD chunk scan kernel against
their plain PyTorch versions, and the main paths at a small size (the
algorithms and GCN training with the kernels against the dense backend, a
hybrid model's prefill and decode with the kernels against the plain
path).

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


def test_lm_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    q = torch.randn(4, 64, 64, device=cuda)
    k = torch.randn(2, 64, 64, device=cuda)
    with pytest.raises(TypeError):
        fk.launch(q.half(), k.half(), k.half())
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
    with pytest.raises(ValueError, match="CUDA"):
        sk.launch(x.cpu(), dt, A, B, B, chunk=128)
    with pytest.raises(ValueError, match="state dim"):
        big = torch.randn(1, 16, 1, 256, device=cuda)
        sk.launch(x, dt, A, big, big, chunk=128)
    with pytest.raises(ValueError, match="chunk"):
        sk.launch(x, dt, A, B, B, chunk=256)


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
