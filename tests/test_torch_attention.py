"""Parity of the port's attention against the JAX package: the flash
attention kernel's plain version (and its CPU dispatch and layout adapter)
against the JAX kernel in interpret mode and its reference, and the
layers of ``models/layers.py``.  Inputs are drawn with numpy from a seed
and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tfk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as tflash_ref  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = 2e-5          # the JAX package's own flash-vs-reference bound
LAYER_TOL = 1e-5


def _qkv(B, S, H, K, hd, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, n, hd).astype(np.float32) for n in (H, K, K)]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("n_rep", [1, 2, 5])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_kernel_and_ref(causal, window, n_rep):
    B, S, K, hd = 2, 64, 2, 16
    q, k, v = _qkv(B, S, K * n_rep, K, hd, seed=n_rep + window)
    want_kernel = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, bq=32, bk=32)
    want_ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window, use_kernel=False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = tflash(tq, tk, tv, causal=causal, window=window,
                   use_kernel=False)
    # the kernel's route on a CPU tensor takes the plain version
    before = tfk.flash_attention_bhsd.launches
    routed = tflash(tq, tk, tv, causal=causal, window=window)
    assert tfk.flash_attention_bhsd.launches == before
    for got in (plain, routed):
        assert got.shape == (B, S, K * n_rep, hd)
        assert _max_err(got.numpy(), want_kernel) < TOL
        assert _max_err(got.numpy(), want_ref) < TOL


@pytest.mark.parametrize("window", [0, 16])
def test_flash_plain_ragged_length_matches_jax_ref(window):
    """S=41 is no multiple of a tile: the JAX kernel does not take it, its
    reference does (and so does the port's CUDA kernel)."""
    BH, BKV, S, d = 6, 2, 41, 32
    rng = np.random.RandomState(41)
    q = rng.randn(BH, S, d).astype(np.float32)
    k = rng.randn(BKV, S, d).astype(np.float32)
    v = rng.randn(BKV, S, d).astype(np.float32)
    want = jflash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, window=window)
    got = tflash_ref(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), causal=True, window=window)
    assert _max_err(got.numpy(), want) < TOL


def test_flash_wrapper_rejects_cpu_tensors_at_launch():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.launch(q, q, q)


def _spec_pair(H, K, hd, window, q_chunk=1024):
    kw = dict(n_heads=H, n_kv_heads=K, head_dim=hd, causal=True,
              window=window, q_chunk=q_chunk)
    return jl.AttnSpec(**kw), tl.AttnSpec(**kw)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(2, 41, 64)).astype(np.float32)
    gamma = (0.1 * rng.randn(64)).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(gamma))
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma))
    assert _max_err(got.numpy(), want) < LAYER_TOL * np.abs(want).max()
    q = rng.randn(2, 41, 4, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 141)[None], (2, 41)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0)
    got = tl.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 10_000.0)
    assert _max_err(got.numpy(), want) < LAYER_TOL * np.abs(want).max()
    np.testing.assert_array_equal(tl.rope_freqs(16, 10_000.0).numpy(),
                                  np.asarray(jl.rope_freqs(16, 10_000.0)))


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("impl", ["attention", "chunked_attention"])
def test_attention_matches_jax(impl, window):
    B, S, H, K, hd = 2, 48, 4, 2, 16
    q, k, v = _qkv(B, S, H, K, hd, seed=7)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    jspec, tspec = _spec_pair(H, K, hd, window, q_chunk=16)
    want = getattr(jl, impl)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jspec, jnp.asarray(pos), jnp.asarray(pos))
    got = getattr(tl, impl)(*(torch.from_numpy(a) for a in (q, k, v)),
                            tspec, torch.from_numpy(pos),
                            torch.from_numpy(pos))
    assert _max_err(got.numpy(), want) < LAYER_TOL


@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_matches_jax(window):
    B, Sc, H, K, hd = 2, 40, 4, 2, 16
    rng = np.random.RandomState(3)
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    kc = rng.randn(B, Sc, K, hd).astype(np.float32)
    vc = rng.randn(B, Sc, K, hd).astype(np.float32)
    pos = np.array([17, 39], np.int32)
    jspec, tspec = _spec_pair(H, K, hd, window)
    want = jl.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jspec, jnp.asarray(pos), Sc)
    got = tl.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), tspec,
                              torch.from_numpy(pos), Sc)
    assert _max_err(got.numpy(), want) < LAYER_TOL


def test_swiglu_and_attn_block_match_jax():
    rng = np.random.RandomState(5)
    D, F, H, K, hd, S = 32, 64, 4, 2, 8, 24
    x = rng.randn(2, S, D).astype(np.float32)
    mlp = {"w_gate": rng.randn(D, F), "w_up": rng.randn(D, F),
           "w_down": rng.randn(F, D)}
    mlp = {k: (v / np.sqrt(v.shape[0])).astype(np.float32)
           for k, v in mlp.items()}
    want = jl.swiglu(jnp.asarray(x), {k: jnp.asarray(v)
                                      for k, v in mlp.items()})
    got = tl.swiglu(torch.from_numpy(x), {k: torch.from_numpy(v)
                                          for k, v in mlp.items()})
    assert _max_err(got.numpy(), want) < LAYER_TOL * np.abs(want).max()
    attn = {"wq": rng.randn(D, H, hd), "wk": rng.randn(D, K, hd),
            "wv": rng.randn(D, K, hd), "wo": rng.randn(H, hd, D)}
    attn = {k: (v / np.sqrt(v.shape[-2])).astype(np.float32)
            for k, v in attn.items()}
    pos = np.broadcast_to(np.arange(S)[None], (2, S)).astype(np.int32)
    for window in (0, 8):
        jspec, tspec = _spec_pair(H, K, hd, window, q_chunk=S)
        want, (wk, wv) = jl.attn_block(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in attn.items()},
            jspec, jnp.asarray(pos), return_kv=True)
        tw = {k: torch.from_numpy(v) for k, v in attn.items()}
        for mode in ("auto", "kernel", "ref"):
            spec = tl.AttnSpec(**{**tspec.__dict__, "kernels": mode})
            got, (gk, gv) = tl.attn_block(torch.from_numpy(x), tw, spec,
                                          torch.from_numpy(pos),
                                          return_kv=True)
            scale = np.abs(want).max()
            assert _max_err(got.numpy(), want) < LAYER_TOL * scale
            assert _max_err(gk.numpy(), wk) < LAYER_TOL * np.abs(wk).max()
            assert _max_err(gv.numpy(), wv) < LAYER_TOL * np.abs(wv).max()
