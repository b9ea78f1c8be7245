"""The flash attention and SSD scan kernels under autograd, on the CPU, and
their plain versions on half types against the JAX package.

``FlashAttention`` and ``SSDChunkScan`` (the kernels' ``autograd.Function``
s) take the wrapper's CPU forward, the plain version, in place of the
kernel, so their backwards are checked here: ``gradcheck`` in float64 on
tiny shapes (causal, windowed, unmasked with Sq > Sk, GQA; the scan with
and without an initial state, at a chunk that divides S and one that does
not), the chunked plain backward of flash equal to autograd of the whole
plain function, and the model's layers under ``kernels="kernel"`` with the
gradients of ``kernels="ref"`` (plain autograd of the model's own
attention and ``ssd_chunked``), within float32 summation order (1e-5 of
each gradient's max).  A wrapper's output is never detached from inputs
that require a gradient.

Step 0: the plain versions on float16 and bfloat16 inputs against the
reference's Pallas kernels in interpret mode on the same inputs: both
compute in float32 and round the output to the input's type once, so they
may differ by one ulp of that type (plus float32's own 2e-5 of max|v|)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jflash)
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as tflash)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref, flash_attention_vjp, vjp_chunk_rows)
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

GRAD_RTOL = 1e-5
HALF = {"float16": (torch.float16, jnp.float16, 10),
        "bfloat16": (torch.bfloat16, jnp.bfloat16, 7)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tests: gradcheck runs thousands of
    tiny float64 ops, which torch's thread pool only slows down, and
    slows by 50-100x when test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(*shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=g, dtype=torch.float64,
                        requires_grad=True) for s in shapes]


@pytest.mark.parametrize("causal,window,Sq,Sk,n_rep", [
    (True, 0, 9, 9, 2), (True, 3, 9, 9, 1), (False, 0, 7, 5, 3),
    (False, 0, 5, 9, 1), (True, 4, 6, 10, 2), (False, 2, 8, 8, 2)])
def test_flash_function_gradcheck(causal, window, Sq, Sk, n_rep):
    q, k, v = _f64((2 * n_rep, Sq, 8), (2, Sk, 8), (2, Sk, 8), seed=Sq)
    out = fk.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.autograd.gradcheck(
        lambda a, b, c: fk.flash_attention_bhsd(a, b, c, causal=causal,
                                                window=window), (q, k, v))


@pytest.mark.parametrize("chunk", [1, 3, 5, 0])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 4), (False, 0)])
def test_flash_vjp_chunks_equal_the_whole(causal, window, chunk):
    q, k, v = _f64((6, 11, 8), (3, 11, 8), (3, 11, 8), seed=chunk)
    do = _f64((6, 11, 8), seed=9)[0].detach()
    want = torch.autograd.grad(flash_attention_ref(
        q, k, v, causal=causal, window=window), (q, k, v), do)
    got = flash_attention_vjp(q, k, v, do, causal=causal, window=window,
                              chunk=chunk)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # a (BH, c, Sk) score chunk of 2^25 floats at TinyLlama's training shape
    assert vjp_chunk_rows(128, 2048, 2048) == 128
    assert vjp_chunk_rows(1, 7, 5) == 7


@pytest.mark.parametrize("i0,i1", [(0, 4), (3, 8), (5, 11), (6, 9)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 4), (False, 0)])
def test_flash_ref_at_offsets_is_a_slice_of_the_whole(causal, window, i0,
                                                      i1):
    """Query rows i0:i1 at positions i0.. against only the keys their mask
    can keep (lo:hi at positions lo..) give the whole call's rows; the
    query heads read their kv head h // n_rep, as with k and v
    repeated."""
    q, k, v = (t.detach() for t in _f64((6, 11, 8), (3, 11, 8), (3, 11, 8),
                                          seed=i0))
    whole = flash_attention_ref(q, k, v, causal=causal, window=window)
    rep = [torch.repeat_interleave(t, 2, dim=0) for t in (k, v)]
    torch.testing.assert_close(
        flash_attention_ref(q, *rep, causal=causal, window=window), whole,
        rtol=1e-12, atol=1e-12)
    hi = i1 if causal else 11
    lo = max(0, i0 - window + 1) if window else 0
    part = flash_attention_ref(q[:, i0:i1], k[:, lo:hi], v[:, lo:hi],
                               causal=causal, window=window, q0=i0, k0=lo)
    torch.testing.assert_close(part, whole[:, i0:i1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chunk,init", [(4, False), (4, True), (3, True)])
def test_ssd_function_gradcheck(chunk, init):
    b, s, h, p, g, n = 1, 8, 2, 3, 1, 2
    x, B, C = _f64((b, s, h, p), (b, s, g, n), (b, s, g, n), seed=chunk)
    gen = torch.Generator().manual_seed(1)
    dt = (torch.rand(b, s, h, generator=gen, dtype=torch.float64) * 0.5
          + 0.1).requires_grad_()
    A = (-torch.rand(h, generator=gen, dtype=torch.float64)
         - 0.2).requires_grad_()
    st = _f64((b, h, p, n), seed=5)[0] if init else None
    y, state = sk.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk, init_state=st)
    assert type(y.grad_fn).__name__ == "SSDChunkScanBackward"
    ins = (x, dt, A, B, C) + ((st,) if init else ())
    assert torch.autograd.gradcheck(
        lambda *a: sk.ssd_chunk_scan(*a[:5], chunk=chunk,
                                     init_state=a[5] if init else None), ins)
    # the final state's gradient alone (y unused)
    assert torch.autograd.gradcheck(
        lambda *a: sk.ssd_chunk_scan(*a[:5], chunk=chunk,
                                     init_state=a[5] if init else None)[1],
        ins)


def _grads(fn, tensors):
    ts = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = fn(*ts)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    return out, torch.autograd.grad(out, ts, cot)


def _close_rel(a, b, rtol=GRAD_RTOL):
    assert a.shape == b.shape
    err = float((a.double() - b.double()).abs().max())
    assert err <= rtol * float(b.double().abs().max()), err


@pytest.mark.parametrize("window", [0, 5])
def test_attn_block_kernel_mode_grads_equal_plain(window):
    spec = tl.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=8, window=window,
                       q_chunk=64)
    rng = np.random.RandomState(window)
    x = torch.from_numpy(rng.randn(2, 12, 16).astype(np.float32))
    w = {k: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3)
         for k, s in (("wq", (16, 4, 8)), ("wk", (16, 2, 8)),
                      ("wv", (16, 2, 8)), ("wo", (4, 8, 16)))}
    pos = torch.arange(12).expand(2, 12)
    keys = list(w)
    outs = {}
    for mode in ("kernel", "ref"):
        s = tl.AttnSpec(**{**spec.__dict__, "kernels": mode})
        outs[mode] = _grads(lambda xx, *ws: tl.attn_block(
            xx, dict(zip(keys, ws)), s, pos), [x] + [w[k] for k in keys])
    _close_rel(outs["kernel"][0], outs["ref"][0])
    for a, b in zip(outs["kernel"][1], outs["ref"][1]):
        _close_rel(a, b)


@pytest.mark.parametrize("s", [16, 12])
def test_mamba_block_kernel_mode_grads_equal_plain(s):
    cfg = SSMConfig(d_state=4, expand=2, head_dim=8, conv_width=4,
                    n_groups=1, chunk=8)
    D, di, h = 16, 32, 4
    rng = np.random.RandomState(s)
    shapes = {"wz": (D, di), "wx": (D, di), "wB": (D, 4), "wC": (D, 4),
              "wdt": (D, h), "conv_x": (4, di), "conv_B": (4, 4),
              "conv_C": (4, 4), "A_log": (h,), "D_skip": (h,),
              "dt_bias": (h,), "norm": (di,), "out_proj": (di, D)}
    w = {k: torch.from_numpy(rng.randn(*v).astype(np.float32) * 0.3)
         for k, v in shapes.items()}
    x = torch.from_numpy(rng.randn(2, s, D).astype(np.float32))
    keys = list(w)
    outs = {mode: _grads(lambda xx, *ws: tssm.mamba_block(
        xx, dict(zip(keys, ws)), cfg, D, kernels=mode)[0],
        [x] + [w[k] for k in keys]) for mode in ("kernel", "ref")}
    _close_rel(outs["kernel"][0], outs["ref"][0])
    for a, b in zip(outs["kernel"][1], outs["ref"][1]):
        _close_rel(a, b)


def _half_close(got, want, mant):
    """Within one ulp of the half type at each value, plus 2e-5 of max."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -14)))
                  - mant)
    bound = ulp + 2e-5 * np.max(np.abs(want))
    assert (np.abs(got - want) <= bound).all(), float(
        np.max(np.abs(got - want) - bound))


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_flash_plain_on_half_types_matches_jax_kernel(dtype, causal, window):
    tdt, jdt, mant = HALF[dtype]
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 64, n, 16).astype(np.float32)
               for n in (4, 2, 2))
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = jflash(jq, jk, jv, causal=causal, window=window, bq=32, bk=32)
    assert want.dtype == jdt
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                  .to(tdt) for a in (jq, jk, jv))
    got = tflash(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt
    _half_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                mant)


@pytest.mark.parametrize("mix", ["float16", "bfloat16", "bf16-x-f32-BC",
                                 "f16-x-bf16-BC"])
def test_ssd_plain_on_half_types_matches_jax_kernel(mix):
    """x, B, C in a half type (or x in one and B, C in another, or in
    float32): y in x's type, as the reference's kernel writes it."""
    b, s, h, p, g, n = 2, 32, 4, 8, 1, 16
    rng = np.random.RandomState(len(mix))
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    A = (-np.exp(0.5 * rng.randn(h))).astype(np.float32)
    B = rng.randn(b, s, g, n).astype(np.float32)
    C = rng.randn(b, s, g, n).astype(np.float32)
    xt, bt = {"float16": ("float16", "float16"),
              "bfloat16": ("bfloat16", "bfloat16"),
              "bf16-x-f32-BC": ("bfloat16", None),
              "f16-x-bf16-BC": ("float16", "bfloat16")}[mix]
    jx = jnp.asarray(x, HALF[xt][1])
    jB, jC = ((jnp.asarray(a, HALF[bt][1]) if bt else jnp.asarray(a))
              for a in (B, C))
    want = jssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, chunk=16)
    assert want.dtype == HALF[xt][1]

    def t(a, name):
        arr = torch.from_numpy(np.asarray(a.astype(jnp.float32)))
        return arr.to(HALF[name][0]) if name else arr
    got, state = sk.ssd_chunk_scan(t(jx, xt), torch.from_numpy(dt),
                                   torch.from_numpy(A), t(jB, bt),
                                   t(jC, bt), chunk=16)
    assert got.dtype == HALF[xt][0] and state.dtype == torch.float32
    _half_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                HALF[xt][2])
    plain, _ = ssd_scan_ref_model(t(jx, xt), torch.from_numpy(dt),
                                  torch.from_numpy(A), t(jB, bt), t(jC, bt))
    assert torch.equal(plain, got)
