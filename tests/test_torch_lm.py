"""The port's model-serving slice against the JAX package, whole: weights
carried across with ``params_from_reference``, prefill logits and every
cache leaf, then four greedy decode steps, on reduced hybrid (hymba: a
window, a global and a window stage), dense (tinyllama; and gemma3 at head
dim 256, the flash kernel's largest, with tied embeddings, in the same
window, global and window stages) and ssm (mamba2) configs, at a prompt that is a chunk multiple (40) and one that is not
(41).  Also the init recipe and the serving CLI.  Gemma-3 and Mamba2's
prefill and decode, the embedding lookups and the cache layout are in
``test_torch_lm_more.py`` (the file was split for time: each case pays for
its reference's compile).

Tolerances.  A single layer of the port agrees with the reference to
float32 summation order (~1e-6 of its values); the random-weight model
amplifies that difference layer by layer, so after four hybrid layers the
K/V leaves differ by up to ~3e-5 and the logits by up to ~6e-5 of their
max (~1.5e-4 over every position of a forward).  So: prefill logits
within 1e-4 of max|logit|, the forward's within 3e-4, the first layer's
cache leaves within 1e-5 of their max, every cache leaf within 1e-4,
``k_pos`` exact; a decode step from the SAME cache (the reference's,
carried across) within 1e-4 of max|logit|, and the four chained decode
steps (each side on its own cache) within 1e-3."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models.transformer import ModelContext as JCtx  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import serve_model  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402

CONFIGS = {
    "hybrid": ("hymba_1_5b", dict(n_layers=4, global_every=3, vocab=250)),
    "dense": ("tinyllama_1_1b", dict(vocab=250)),
    "gemma3": ("gemma3_4b", dict(n_layers=4, global_every=3, head_dim=256,
                                 vocab=250)),
    "ssm": ("mamba2_1_3b", dict(vocab=250)),
}
B, GEN = 2, 4
LOGIT_RTOL = 1e-4
CACHE_RTOL = 1e-4
FIRST_LAYER_RTOL = 1e-5
STEP_RTOL = 1e-4
CHAIN_RTOL = 1e-3
FORWARD_RTOL = 3e-4     # every position of the forward, not the last one


def _cfgs(kind):
    arch, over = CONFIGS[kind]
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


@functools.lru_cache(maxsize=None)
def _reference(kind, S):
    """The JAX package's prefill and 4 greedy decode steps, as numpy:
    (params, prompts, prefill logits, prefill cache, [(token, logits,
    cache before the step)])."""
    jcfg, _ = _cfgs(kind)
    params = jzoo.init_params(jcfg, jax.random.PRNGKey(0), 1, jnp.float32)
    toks = np.random.RandomState(S).randint(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    ctx = JCtx(mesh=None, remat="none", q_chunk=max(S, 64))
    logits, cache = jzoo.prefill(params, jcfg, ctx, jnp.asarray(toks),
                                 max_len=S + GEN)
    to_np = functools.partial(jax.tree.map, np.asarray)
    pre = (np.asarray(logits), to_np(cache))
    steps = []
    for _ in range(GEN):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        before = to_np(cache)
        logits, cache = jzoo.decode_step(params, jcfg, ctx, tok, cache)
        steps.append((np.asarray(tok), np.asarray(logits), before))
    return to_np(params), toks, pre, steps


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _check_logits(got, want, vocab, rtol):
    got = got.numpy()
    np.testing.assert_array_equal(got[:, vocab:], want[:, vocab:])  # -2^30
    assert _rel(got[:, :vocab], want[:, :vocab]) <= rtol


def _check_cache(tc, jc):
    assert len(tc["stages"]) == len(jc["stages"])
    np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
    for si, (ts, js) in enumerate(zip(tc["stages"], jc["stages"])):
        assert set(ts) == set(js)
        for key in js:
            if key == "k_pos":
                np.testing.assert_array_equal(ts[key].numpy(), js[key])
                continue
            pairs = (zip(ts[key], js[key]) if key == "conv"
                     else [(ts[key], js[key])])
            for t, j in pairs:
                assert _rel(t.numpy(), j) <= CACHE_RTOL, (si, key)
                if si == 0:
                    assert _rel(t.numpy()[0], j[0]) <= FIRST_LAYER_RTOL, key


@pytest.mark.parametrize("S", [40, 41])
@pytest.mark.parametrize("kind", ["hybrid", "dense"])
@pytest.mark.parametrize("mode", ["auto", "kernel"])
def test_prefill_and_decode_match_jax(kind, S, mode):
    check_prefill_and_decode(kind, S, mode)


def check_prefill_and_decode(kind, S, mode):
    """On the CPU, "auto" takes the reference's plain choices and "kernel"
    the kernels' wrappers (their plain versions: the flash reference and
    the recurrence with cfg.chunk and a ragged last chunk)."""
    jcfg, tcfg = _cfgs(kind)
    jparams, toks, (jlogits, jcache), steps = _reference(kind, S)
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    ctx = TCtx(q_chunk=max(S, 64), kernels=mode)
    logits, cache = tzoo.prefill(params, tcfg, ctx, torch.from_numpy(toks),
                                 max_len=S + GEN)
    _check_logits(logits, jlogits, tcfg.vocab, LOGIT_RTOL)
    _check_cache(cache, jcache)
    for tok, jl, jbefore in steps:
        # one step from the reference's own cache: the step alone
        lg, _ = tzoo.decode_step(params, tcfg, ctx, torch.from_numpy(tok),
                                 _to_torch(jbefore))
        _check_logits(lg, jl, tcfg.vocab, STEP_RTOL)
        # the chain on the port's own cache
        logits, cache = tzoo.decode_step(params, tcfg, ctx,
                                         torch.from_numpy(tok), cache)
        _check_logits(logits, jl, tcfg.vocab, CHAIN_RTOL)


def test_forward_logits_match_jax():
    jcfg, tcfg = _cfgs("hybrid")
    jparams, toks, _, _ = _reference("hybrid", 41)
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    want, _ = jzoo.forward_logits(jax.tree.map(jnp.asarray, jparams), jcfg,
                                  JCtx(mesh=None, remat="none", q_chunk=64),
                                  jnp.asarray(toks))
    got, aux = tzoo.forward_logits(params, tcfg, TCtx(q_chunk=64),
                                   torch.from_numpy(toks))
    assert float(aux) == 0.0
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy()[..., tcfg.vocab:],
                                  want[..., tcfg.vocab:])
    assert _rel(got.numpy()[..., :tcfg.vocab],
                want[..., :tcfg.vocab]) <= FORWARD_RTOL


def test_params_from_reference_and_init_recipe():
    jcfg, tcfg = _cfgs("hybrid")
    jparams = jax.tree.map(np.asarray, jzoo.init_params(
        jcfg, jax.random.PRNGKey(3), 1, jnp.float32))
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = [t for _, t in tzoo._leaves(params)]
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(b.numpy(), a)
    init = tzoo.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for _, t in tzoo._leaves(init)] == [
        a.shape for a in flat_j]
    layer = init["stages"][0]["layers"]
    assert not layer["norm1"].any() and not init["final_norm"].any()
    np.testing.assert_allclose(layer["ssm"]["A_log"][0].numpy(),
                               np.log(np.arange(1, tcfg.n_ssm_heads + 1)),
                               rtol=1e-6)
    assert bool((layer["ssm"]["D_skip"] == 1).all())
    np.testing.assert_allclose(layer["ssm"]["dt_bias"].numpy(),
                               np.log(np.expm1(0.01)), rtol=1e-6)
    wq = init["stages"][0]["layers"]["attn"]["wq"]     # (L, D, H, hd)
    # the reference's fan_in is shape[-2] for every leaf (H here)
    assert abs(float(wq.std()) * np.sqrt(wq.shape[-2]) - 1.0) < 0.05
    tied = dataclasses.replace(tcfg, tie_embeddings=True)
    p = tzoo.init_params(tied, torch.Generator().manual_seed(0), "cpu")
    assert p["out_embed"] is p["embed"]


def test_other_stage_kinds_raise():
    """A stage of a kind the port does not know raises, in the full-sequence
    and the decode path; every kind of the reference runs (``moe`` in
    ``test_torch_lm_moe.py``, ``enc`` and ``dec_cross`` in
    ``test_torch_lm_whisper.py``)."""
    from repro_torch.models import transformer as ttf
    cfg = tget("whisper_medium").reduced()
    params = tzoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    sp = params["stages"][0]
    h = torch.zeros((1, 3, cfg.d_model))
    pos = torch.arange(3, dtype=torch.int32)[None]
    unknown = ttf.StageSpec("conv", cfg.n_layers)
    with pytest.raises(NotImplementedError, match="stage kind 'conv'"):
        ttf.apply_stage_seq(h, sp, unknown, cfg, TCtx(), pos)
    with pytest.raises(NotImplementedError, match="stage kind 'conv'"):
        ttf.apply_stage_decode(h[:, :1], sp, unknown, cfg, TCtx(), pos[:, 0],
                               {})
    with pytest.raises(NotImplementedError, match="stage kind 'conv'"):
        ttf.check_kind(unknown)


def test_serve_model_runs_on_the_cpu(capsys):
    toks = serve_model.run("hymba_1_5b", True, batch=2, prompt_len=20, gen=5,
                           device="cpu")
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    serve_model.main(["--arch", "mamba2_1_3b", "--batch", "2",
                      "--prompt-len", "9", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] hymba_1_5b: batch=2 prompt=20 gen=5" in out
    assert "[serve] mamba2_1_3b: batch=2 prompt=9 gen=3" in out
    assert "[serve] sample generations (token ids):" in out
