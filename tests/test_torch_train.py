"""The port's LM training loss against the JAX package: ``SyntheticLM``
batches and ``token_stats`` bitwise, then ``loss_fn``'s value and every
leaf's gradient against ``jax.value_and_grad`` of
``repro.models.model_zoo.loss_fn``, with the weights carried across
(``state_from_reference``: every leaf a tensor of its own, so a tied
``out_embed`` takes its own gradient as the JAX leaf does), for reduced
TinyLlama (dense), Gemma-3 (tied embeddings; window, global and window
layers), Hymba (hybrid: attention and a Mamba-2 mixer), OLMoE (the aux
loss; the experts each layer chooses must be the reference's, and the
seeds keep the router probabilities free of exact ties) and Whisper
(``enc_embeds``; the encoder's gradient comes through cross-attention);
the last two, the lookups and the recomputation modes are in
``test_torch_train_loss.py``.
Both kernel modes: ``"ref"`` (the plain attention and ``ssd_chunked``)
and ``"kernel"`` (the kernels' wrappers, whose CPU forward is the plain
version and whose backward is the ``autograd.Function``'s).

Tolerances.  The loss within rtol 1e-6 (float32 summation order; measured
up to 4.3e-7).  A leaf's gradient within ``GRAD_RTOL`` = 3e-3 of its max
|value|: the backward sums float32 products in another order at every
layer, and where a softmax saturates the gradient cancels: Whisper's
encoder query weights are the worst leaf, where the reference's own
float32 gradient lies 9.3e-4 of the leaf's max from a float64 run of the
port (the port's 2.2e-4); every other leaf is within 2e-4."""
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
from repro.train import data as jdata  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.checkpoint import _leaves_with_paths  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402
from test_torch_lm_moe import _Routes, _same_experts  # noqa: E402

ARCHS = {
    "tinyllama_1_1b": {},
    "gemma3_4b": dict(n_layers=3, global_every=2, tie_embeddings=True),
    "hymba_1_5b": dict(n_layers=3, global_every=2),
    "olmoe_1b_7b": {},
    "whisper_medium": {},
}
B, S = 2, 24          # S > the reduced window (16): the windows mask
LOSS_RTOL = 1e-6
GRAD_RTOL = 3e-3


def state_from_reference(tree, device="cpu"):
    """A tree of the JAX package as numpy arrays (a train state, params,
    gradients) as the port's: dicts keyed in sorted order, lists in
    order, each leaf a tensor of its own (a tied ``out_embed`` too)."""
    if isinstance(tree, dict):
        return {k: state_from_reference(tree[k], device) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_reference(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def cfgs(arch):
    over = ARCHS[arch]
    return (dataclasses.replace(jget(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


def batch_np(cfg, seed=1, b=B, s=S):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.enc_dec:
        out["enc_embeds"] = rng.randn(b, cfg.enc_seq, cfg.d_model).astype(
            np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def flat_np(tree):
    """keystr path -> numpy leaf, for a JAX tree."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_torch(tree):
    return {k: v.detach().numpy() for k, v in _leaves_with_paths(tree)}


def close_per_leaf(got: dict, want: dict, rtol: float, atol: float = 0.0):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        err = float(np.max(np.abs(g.astype(np.float64) - w), initial=0.0))
        assert err <= rtol * float(np.max(np.abs(w), initial=0.0)) + atol, (
            k, err, float(np.max(np.abs(w), initial=0.0)))


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The JAX package's params, batch, loss, metrics and gradients (numpy),
    and the experts each MoE layer chose (an unrolled forward, so that the
    routing is concrete)."""
    jcfg, _ = cfgs(arch)
    params = jzoo.init_params(jcfg, jax.random.PRNGKey(0), 1, jnp.float32)
    batch = batch_np(jcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    ctx = JCtx(mesh=None, remat="none", q_chunk=max(S, 64))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jzoo.loss_fn(p, jcfg, ctx, jb), has_aux=True))(params)
    routes = None
    if jcfg.is_moe:
        with _Routes(jmoe) as routes:
            jzoo.forward_logits(params, jcfg, dataclasses.replace(
                ctx, scan_layers=False), jb["tokens"])
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()}, flat_np(grads),
            routes)


def port_loss_and_grads(arch, ctx, batch=None):
    """The port's loss, metrics and gradients (keystr -> numpy) on the
    reference's weights and batch."""
    _, tcfg = cfgs(arch)
    params, ref_batch, *_ = reference(arch)
    p = tree_map(lambda t: t.requires_grad_(True),
                 state_from_reference(params, "cpu"))
    loss, metrics = tzoo.loss_fn(p, tcfg, ctx, to_torch(
        ref_batch if batch is None else batch))
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
    paths = [k for k, _ in _leaves_with_paths(p)]
    return loss, metrics, {
        k: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
        for k, t, g in zip(paths, tree_leaves(p), grads)}


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_bitwise_equal_to_jax(seed, n_shards):
    cfg = dict(vocab=32000, seq_len=64, global_batch=8, seed=seed)
    want = jdata.SyntheticLM(jdata.DataConfig(**cfg))
    got = tdata.SyntheticLM(tdata.DataConfig(**cfg))
    for step in (0, 1, 7, 1000):
        for shard in range(n_shards):
            a = got.batch_at(step, shard, n_shards)["tokens"]
            b = want.batch_at(step, shard, n_shards)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        assert tdata.token_stats(got.batch_at(step)["tokens"]) == \
            jdata.token_stats(want.batch_at(step)["tokens"])
    for a, b, _ in zip(iter(got), iter(want), range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="shards"):
        got.batch_at(0, 0, 3)


def check_loss_and_grads(arch, mode):
    """The port's loss, metrics and every leaf's gradient against the
    reference's (and, for OLMoE, each layer's experts)."""
    _, tcfg = cfgs(arch)
    params, batch, want_loss, want_metrics, want_grads, want_routes = \
        reference(arch)
    ctx = TCtx(q_chunk=max(S, 64), remat="none", kernels=mode)
    loss, metrics, grads = port_loss_and_grads(arch, ctx)
    assert abs(float(loss.detach()) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert set(metrics) == set(want_metrics) == {"nll", "aux"}
    assert abs(float(metrics["nll"].detach()) - want_metrics["nll"]) <= \
        LOSS_RTOL * want_metrics["nll"]
    assert abs(float(metrics["aux"].detach()) - want_metrics["aux"]) <= \
        LOSS_RTOL * max(want_metrics["aux"], 1.0)
    if arch == "olmoe_1b_7b":
        assert want_metrics["aux"] > 0
        tb = to_torch(batch)
        with torch.no_grad(), _Routes(tmoe) as routes:
            tzoo.forward_logits(state_from_reference(params, "cpu"), tcfg,
                                ctx, tb["tokens"])
        _same_experts(routes, want_routes)
    close_per_leaf(grads, want_grads, GRAD_RTOL)
    if ARCHS[arch].get("tie_embeddings"):
        # two leaves, two gradients: the lookup's and the logits'
        assert not np.allclose(grads["['embed']"], grads["['out_embed']"])


@pytest.mark.parametrize("mode", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma3_4b",
                                  "hymba_1_5b"])
def test_loss_and_grads_match_jax(arch, mode):
    check_loss_and_grads(arch, mode)
