"""The port's ``moe`` stage kind against the JAX package, whole: OLMoE-1B-7B
(64 experts top-8 at full size; 4 experts top-2 reduced) and
Llama-4-Scout (16 experts top-1; 4 top-1 reduced) at ``.reduced()`` with
the weights carried across by ``params_from_reference``: the forward's
logits and aux loss, prefill's logits and caches, and 4 greedy decode
steps, against ``forward_logits`` / ``prefill`` / ``decode_step``, at a
prompt of 40 tokens (B*S a multiple of E) and 41.

Routing is discontinuous, so every MoE layer of every call must choose
the SAME experts as the reference (both sides' ``router_probs`` are
wrapped to record ``idx``; the reference runs unrolled, without
``lax.scan``, so that its values are concrete).  The seeds give router
probabilities with no exact tie (asserted), the condition under which
``torch.topk`` and ``lax.top_k`` agree.

Capacity depends on T: a decode step routes B tokens (cap 1 here, so
tokens that share an expert are dropped), the forward B*S; both packages
use the same T and caps, and are held to each other, never decode to the
forward.

Tolerances as ``test_torch_lm.py`` (float32 rounding, amplified layer by
layer by the random weights): prefill logits within 1e-4 of max|logit|,
the forward's within 3e-4, cache leaves within 1e-4 (the first layer's
1e-5), ``k_pos`` exact, a decode step from the reference's own cache
within 1e-4, the chained steps within 1e-3; the aux loss within rtol
1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import ModelContext as JCtx  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import serve_model  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402
from test_torch_lm import (CHAIN_RTOL, FORWARD_RTOL,  # noqa: E402
                           LOGIT_RTOL, STEP_RTOL, _check_cache,
                           _check_logits, _rel, _to_torch)

ARCHS = ("olmoe_1b_7b", "llama4_scout_17b_a16e")
B, GEN = 2, 4
AUX_RTOL = 1e-5


def _cfgs(arch):
    return jget(arch).reduced(), tget(arch).reduced()


class _Routes:
    """Record the experts each MoE call of one package chooses."""

    def __init__(self, mod):
        self.mod, self.idx, self.probs = mod, [], []
        self.saved = mod.router_probs

    def __enter__(self):
        def rec(x, w, k):
            out = self.saved(x, w, k)
            self.idx.append(np.asarray(out[1]))
            self.probs.append(np.asarray(out[2]))
            return out
        self.mod.router_probs = rec
        return self

    def __exit__(self, *exc):
        self.mod.router_probs = self.saved


def _no_ties(probs):
    for p in probs:
        assert (np.diff(np.sort(p, axis=-1), axis=-1) > 0).all(), (
            "a router tie: pick another seed")


def _same_experts(t_routes, j_routes):
    assert len(t_routes.idx) == len(j_routes.idx) > 0
    _no_ties(j_routes.probs)
    for a, b in zip(t_routes.idx, j_routes.idx):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _reference(arch, S):
    """The JAX package's forward, prefill and 4 greedy decode steps, as
    numpy, with the experts chosen in each call."""
    jcfg, _ = _cfgs(arch)
    params = jzoo.init_params(jcfg, jax.random.PRNGKey(0), 1, jnp.float32)
    toks = np.random.RandomState(S).randint(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    ctx = JCtx(mesh=None, remat="none", q_chunk=max(S, 64),
               scan_layers=False)
    to_np = functools.partial(jax.tree.map, np.asarray)
    with _Routes(jmoe) as fwd_routes:
        fwd = jzoo.forward_logits(params, jcfg, ctx, jnp.asarray(toks))
    with _Routes(jmoe) as pre_routes:
        logits, cache = jzoo.prefill(params, jcfg, ctx, jnp.asarray(toks),
                                     max_len=S + GEN)
    pre = (np.asarray(logits), to_np(cache))
    steps = []
    for _ in range(GEN):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        before = to_np(cache)
        with _Routes(jmoe) as routes:
            logits, cache = jzoo.decode_step(params, jcfg, ctx, tok, cache)
        steps.append((np.asarray(tok), np.asarray(logits), before, routes))
    return (to_np(params), toks, (np.asarray(fwd[0]), float(fwd[1]),
                                  fwd_routes), (pre, pre_routes), steps)


@pytest.mark.parametrize("S", [40, 41])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch, S):
    _, tcfg = _cfgs(arch)
    jparams, toks, (want, want_aux, j_routes), _, _ = _reference(arch, S)
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    with _Routes(tmoe) as t_routes:
        got, aux = tzoo.forward_logits(params, tcfg, TCtx(q_chunk=64),
                                       torch.from_numpy(toks))
    _same_experts(t_routes, j_routes)
    assert len(t_routes.idx) == tcfg.n_layers
    np.testing.assert_array_equal(got.numpy()[..., tcfg.vocab:],
                                  want[..., tcfg.vocab:])
    assert _rel(got.numpy()[..., :tcfg.vocab],
                want[..., :tcfg.vocab]) <= FORWARD_RTOL
    # the stage's aux is the sum of its layers' (the reference's scan)
    assert want_aux > 1.0
    assert abs(float(aux) - want_aux) <= AUX_RTOL * want_aux


@pytest.mark.parametrize("S", [40, 41])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, S):
    _, tcfg = _cfgs(arch)
    jparams, toks, _, ((jlogits, jcache), j_routes), steps = _reference(
        arch, S)
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    ctx = TCtx(q_chunk=max(S, 64))
    with _Routes(tmoe) as t_routes:
        logits, cache = tzoo.prefill(params, tcfg, ctx,
                                     torch.from_numpy(toks), max_len=S + GEN)
    _same_experts(t_routes, j_routes)
    _check_logits(logits, jlogits, tcfg.vocab, LOGIT_RTOL)
    _check_cache(cache, jcache)
    for tok, jl, jbefore, j_step_routes in steps:
        # one step from the reference's own cache: the step alone
        with _Routes(tmoe) as t_routes:
            lg, _ = tzoo.decode_step(params, tcfg, ctx, torch.from_numpy(tok),
                                     _to_torch(jbefore))
        _same_experts(t_routes, j_step_routes)
        _check_logits(lg, jl, tcfg.vocab, STEP_RTOL)
        # the chain on the port's own cache
        logits, cache = tzoo.decode_step(params, tcfg, ctx,
                                         torch.from_numpy(tok), cache)
        _check_logits(logits, jl, tcfg.vocab, CHAIN_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_layout_and_init_recipe(arch):
    """The MoE leaves carry across unchanged, and ``init_params`` draws
    them with the reference's fan_in, shape[-2]: D for the router and the
    gate / up weights, F for the down weights."""
    jcfg, tcfg = _cfgs(arch)
    jparams = jax.tree.map(np.asarray, jzoo.init_params(
        jcfg, jax.random.PRNGKey(3), 1, jnp.float32))
    params = tzoo.params_from_reference(jparams, tcfg, "cpu")
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = [t for _, t in tzoo._leaves(params)]
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(b.numpy(), a)
    full = tget(arch)
    m = tzoo.stage_param_shapes(full, tzoo.build_stages(full)[0])["moe"]
    L, D, E, F = (full.n_layers, full.d_model, full.moe.n_experts,
                  full.moe.d_ff_expert)
    assert m == {"router": (L, D, E), "w_gate": (L, E, D, F),
                 "w_up": (L, E, D, F), "w_down": (L, E, F, D),
                 "w_gate_m": (L, 1, D, F), "w_up_m": (L, 1, D, F),
                 "w_down_m": (L, 1, F, D)}
    big = dataclasses.replace(tcfg, d_model=256, moe=dataclasses.replace(
        tcfg.moe, d_ff_expert=512))
    init = tzoo.init_params(big, torch.Generator().manual_seed(0), "cpu")
    w = init["stages"][0]["layers"]["moe"]
    for name, fan_in in (("router", 256), ("w_gate", 256), ("w_up", 256),
                         ("w_gate_m", 256), ("w_down", 512),
                         ("w_down_m", 512)):
        assert abs(float(w[name].std()) * np.sqrt(fan_in) - 1.0) < 0.05, name


@pytest.mark.parametrize("arch", ARCHS)
def test_build_cache_matches_jax_layout(arch):
    jcfg, tcfg = _cfgs(arch)
    want = jzoo.build_cache(jcfg, 3, 24, JCtx(mesh=None))
    got = tzoo.build_cache(tcfg, 3, 24, TCtx(), device="cpu")
    flat_j = jax.tree_util.tree_leaves(want)
    flat_t = jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor)
    assert [a.shape for a in flat_j] == [tuple(t.shape) for t in flat_t]
    assert [str(a.dtype) for a in flat_j] == [
        str(t.dtype).replace("torch.", "") for t in flat_t]


def test_serve_model_olmoe_reduced_on_the_cpu(capsys):
    toks = serve_model.run("olmoe_1b_7b", True, batch=2, prompt_len=12,
                           gen=3, device="cpu")
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
    serve_model.main(["--arch", "llama4_scout_17b_a16e", "--batch", "2",
                      "--prompt-len", "9", "--gen", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] olmoe_1b_7b: batch=2 prompt=12 gen=3" in out
    assert "[serve] llama4_scout_17b_a16e: batch=2 prompt=9 gen=2" in out
