"""The port's encoder-decoder stage kinds (``enc``, ``dec_cross``) against
the JAX package: Whisper-medium at ``.reduced()`` (2 encoder and 2 decoder
layers, 16 frames, vocab cut to 250 so that 6 padded logits must read
-2^30), with the weights carried across by ``params_from_reference`` and
the frame embeddings drawn with numpy for both.  Held: the forward's
logits, prefill's logits and caches (each layer's k and v, ``k_pos``,
``pos`` and the encoder's output ``enc_out``), 4 greedy decode steps; the
encoder alone with a query chunk small enough that the reference's
``chunked_attention`` runs unmasked; ``_cross_attend`` with the prompt
longer (37 tokens) and shorter (8) than the 16 frames; the ``"kernel"``
route (the flash kernel's wrapper, its plain version on the CPU) equal to
the ``"ref"`` route.

Tolerances are ``test_torch_lm.py``'s (float32 rounding, amplified layer
by layer by the random weights): prefill logits within 1e-4 of
max|logit|, the forward's within 3e-4, cache leaves and ``enc_out``
within 1e-4, one layer's update (``_cross_attend``) within 1e-5, ``k_pos``
exact, a decode step from the reference's own cache within 1e-4, the
chained steps within 1e-3."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import serve_model  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_lm import (CACHE_RTOL, CHAIN_RTOL,  # noqa: E402
                           FIRST_LAYER_RTOL, FORWARD_RTOL, LOGIT_RTOL,
                           STEP_RTOL, _check_cache, _check_logits, _rel,
                           _to_torch)

ARCH = "whisper_medium"
B, GEN = 2, 4
PROMPTS = (37, 8)          # longer and shorter than the reduced 16 frames


def _cfgs():
    return (dataclasses.replace(jget(ARCH).reduced(), vocab=250),
            dataclasses.replace(tget(ARCH).reduced(), vocab=250))


def _jctx(S, q_chunk=None):
    return jtf.ModelContext(mesh=None, remat="none",
                            q_chunk=q_chunk or max(S, 64))


def _inputs(cfg, S):
    """The prompts, then the frame embeddings, from one numpy stream (as
    serve_model draws them)."""
    rng = np.random.RandomState(S)
    toks = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    enc = rng.randn(B, cfg.enc_seq, cfg.d_model).astype(np.float32)
    return toks, enc


@functools.lru_cache(maxsize=None)
def _reference(S):
    """The JAX package's params, inputs, prefill and 4 greedy decode
    steps, as numpy: (params, prompts, frames, prefill logits, prefill
    cache, [(token, logits, cache before the step)])."""
    jcfg, _ = _cfgs()
    params = jzoo.init_params(jcfg, jax.random.PRNGKey(0), 1, jnp.float32)
    toks, enc = _inputs(jcfg, S)
    ctx = _jctx(S)
    logits, cache = jzoo.prefill(params, jcfg, ctx, jnp.asarray(toks),
                                 enc_embeds=jnp.asarray(enc),
                                 max_len=S + GEN)
    to_np = functools.partial(jax.tree.map, np.asarray)
    pre = (np.asarray(logits), to_np(cache))
    steps = []
    for _ in range(GEN):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        before = to_np(cache)
        logits, cache = jzoo.decode_step(params, jcfg, ctx, tok, cache)
        steps.append((np.asarray(tok), np.asarray(logits), before))
    return to_np(params), toks, enc, pre, steps


def _port(S, mode="auto"):
    _, tcfg = _cfgs()
    jparams, toks, enc, _, _ = _reference(S)
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    return tcfg, params, torch.from_numpy(toks), torch.from_numpy(enc), \
        ttf.ModelContext(q_chunk=max(S, 64), kernels=mode)


@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("mode", ["auto", "kernel"])
def test_prefill_and_decode_match_jax(S, mode):
    """Prefill's logits and every cache leaf (enc_out among them), then 4
    decode steps, each from the reference's own cache and chained on the
    port's; on the CPU "auto" takes the reference's plain attention and
    "kernel" the flash kernel's wrapper (its plain version: unmasked with
    Sq > Sk for the 37-token prompt's cross-attention, Sq = 1 in decode)."""
    tcfg, params, toks, enc, ctx = _port(S, mode)
    _, _, _, (jlogits, jcache), steps = _reference(S)
    logits, cache = tzoo.prefill(params, tcfg, ctx, toks, enc_embeds=enc,
                                 max_len=S + GEN)
    _check_logits(logits, jlogits, tcfg.vocab, LOGIT_RTOL)
    _check_cache(cache, jcache)
    assert set(cache) == set(jcache) == {"stages", "pos", "enc_out"}
    assert _rel(cache["enc_out"].numpy(), jcache["enc_out"]) <= CACHE_RTOL
    for tok, jl, jbefore in steps:
        lg, stepped = tzoo.decode_step(params, tcfg, ctx,
                                       torch.from_numpy(tok),
                                       _to_torch(jbefore))
        _check_logits(lg, jl, tcfg.vocab, STEP_RTOL)
        assert stepped["enc_out"] is not None
        logits, cache = tzoo.decode_step(params, tcfg, ctx,
                                         torch.from_numpy(tok), cache)
        _check_logits(logits, jl, tcfg.vocab, CHAIN_RTOL)
    np.testing.assert_array_equal(cache["enc_out"].numpy(),
                                  tzoo.prefill(params, tcfg, ctx, toks,
                                               enc_embeds=enc)[1]
                                  ["enc_out"].numpy())


@pytest.mark.parametrize("S", PROMPTS)
def test_forward_logits_match_jax(S):
    jcfg, tcfg = _cfgs()
    jparams, toks, enc, _, _ = _reference(S)
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    want, _ = jzoo.forward_logits(jax.tree.map(jnp.asarray, jparams), jcfg,
                                  _jctx(S), jnp.asarray(toks),
                                  enc_embeds=jnp.asarray(enc))
    got, aux = tzoo.forward_logits(params, tcfg,
                                   ttf.ModelContext(q_chunk=max(S, 64)),
                                   torch.from_numpy(toks),
                                   enc_embeds=torch.from_numpy(enc))
    assert float(aux) == 0.0
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy()[..., tcfg.vocab:],
                                  want[..., tcfg.vocab:])
    assert _rel(got.numpy()[..., :tcfg.vocab],
                want[..., :tcfg.vocab]) <= FORWARD_RTOL


@pytest.mark.parametrize("mode", ["ref", "kernel"])
def test_encoder_chunked_matches_jax(mode):
    """The encoder alone at q_chunk 4 of 16 frames: the reference's
    ``chunked_attention`` (a scan over 4 query chunks, unmasked) against
    the port's chunked loop ("ref") and the kernel's route ("kernel")."""
    jcfg, tcfg = _cfgs()
    jparams, _, enc, _, _ = _reference(PROMPTS[0])
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    want = jzoo._run_encoder(jax.tree.map(jnp.asarray, jparams), jcfg,
                             _jctx(4, q_chunk=4), jnp.asarray(enc))
    got = tzoo._run_encoder(params, tcfg,
                            ttf.ModelContext(q_chunk=4, kernels=mode),
                            torch.from_numpy(enc))
    assert got.shape == (B, tcfg.enc_seq, tcfg.d_model)
    assert _rel(got.numpy(), np.asarray(want)) <= CACHE_RTOL


@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("mode", ["ref", "kernel"])
def test_cross_attend_matches_jax(S, mode):
    """One decoder layer's cross-attention update on the same input, the
    prompt longer (37) and shorter (8) than the 16 frames, at the prefill's
    positions and at one decode position."""
    jcfg, tcfg = _cfgs()
    jparams, _, enc, _, _ = _reference(S)
    rng = np.random.RandomState(S + 1)
    h = rng.randn(B, S, tcfg.d_model).astype(np.float32)
    enc_out = rng.randn(B, tcfg.enc_seq, tcfg.d_model).astype(np.float32)
    layer = {k: jax.tree.map(lambda x: x[0], v) for k, v in
             jparams["stages"][0]["layers"].items()}
    jspec = jtf._attn_spec(jcfg, 0, ctx=_jctx(S))
    tspec = ttf._attn_spec(tcfg, 0, ttf.ModelContext(q_chunk=max(S, 64),
                                                      kernels=mode))
    tw = _to_torch(layer)
    for pos in (np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)),
                np.full((B, 1), S + 3, np.int32)):
        hs = h[:, :pos.shape[1]]
        want = jtf._cross_attend(jnp.asarray(hs),
                                 jax.tree.map(jnp.asarray, layer), jspec,
                                 jcfg, jnp.asarray(pos), jnp.asarray(enc_out))
        got = ttf._cross_attend(torch.from_numpy(hs), tw, tspec, tcfg,
                                torch.from_numpy(np.array(pos)),
                                torch.from_numpy(enc_out))
        assert _rel(got.numpy(), np.asarray(want)) <= FIRST_LAYER_RTOL


@pytest.mark.parametrize("S", PROMPTS)
def test_kernel_and_ref_routes_agree(S):
    """The flash kernel's route ("kernel": its plain version on the CPU,
    unmasked for the encoder and cross-attention) against the reference's
    choice ("ref"): the forward's logits within the forward's tolerance."""
    tcfg, params, toks, enc, _ = _port(S)
    out = {mode: tzoo.forward_logits(
        params, tcfg, ttf.ModelContext(q_chunk=max(S, 64), kernels=mode),
        toks, enc_embeds=enc)[0].numpy() for mode in ("kernel", "ref")}
    np.testing.assert_array_equal(out["kernel"][..., tcfg.vocab:],
                                  out["ref"][..., tcfg.vocab:])
    assert _rel(out["kernel"][..., :tcfg.vocab],
                out["ref"][..., :tcfg.vocab]) <= FORWARD_RTOL


def test_params_from_reference_and_init_recipe():
    """The enc subtree and the cross leaves: the reference's flatten order
    (``enc`` between ``embed`` and ``final_norm``), shapes and values."""
    jcfg, tcfg = _cfgs()
    jparams = _reference(PROMPTS[0])[0]
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_t = list(tzoo._leaves(params))
    assert len(flat_j) == len(flat_t)
    for (jp, a), (tp, b) in zip(flat_j, flat_t):
        assert jax.tree_util.keystr(jp) == "".join(f"[{k!r}]" for k in tp)
        np.testing.assert_array_equal(b.numpy(), a)
    assert [p[0] for p, _ in flat_t].index("enc") == 1
    init = tzoo.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for _, t in tzoo._leaves(init)] == [
        a.shape for _, a in flat_j]
    layer = init["stages"][0]["layers"]
    assert not layer["norm_cross"].any()
    assert not init["enc"]["final_norm"].any()
    assert layer["cross"]["wq"].shape == (tcfg.n_layers, tcfg.d_model,
                                          tcfg.n_heads, tcfg.hd)
    assert "cross" not in init["enc"]["stages"][0]["layers"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_builds_every_arch(arch):
    """Every architecture's reduced config builds: no stage kind is
    refused any more."""
    cfg = tget(arch).reduced()
    params = tzoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tzoo.n_params(params) > 0
    assert ("enc" in params) == cfg.enc_dec


def test_build_cache_matches_jax_layout():
    jcfg, tcfg = _cfgs()
    want = jzoo.build_cache(jcfg, 3, 24, _jctx(24))
    got = tzoo.build_cache(tcfg, 3, 24, ttf.ModelContext(), device="cpu")
    assert set(got) == set(want) == {"stages", "pos", "enc_out"}
    flat_j = jax.tree_util.tree_leaves(want)
    flat_t = jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor)
    assert [a.shape for a in flat_j] == [tuple(t.shape) for t in flat_t]
    assert [str(a.dtype) for a in flat_j] == [
        str(t.dtype).replace("torch.", "") for t in flat_t]


def test_prefill_needs_the_frame_embeddings():
    tcfg, params, toks, _, ctx = _port(PROMPTS[1])
    with pytest.raises(ValueError, match="enc_embeds"):
        tzoo.prefill(params, tcfg, ctx, toks)


def test_serve_model_runs_whisper_on_the_cpu(capsys):
    toks = serve_model.run(ARCH, True, batch=2, prompt_len=20, gen=4,
                           device="cpu")
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    serve_model.main(["--arch", ARCH, "--reduced", "--batch", "2",
                      "--prompt-len", "9", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}: batch=2 prompt=20 gen=4" in out
    assert f"[serve] {ARCH}: batch=2 prompt=9 gen=3" in out
