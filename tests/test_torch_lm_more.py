"""The port's model-serving slice against the JAX package (the machinery
and tolerances of ``test_torch_lm.py``, of which this file is the second
half): Gemma-3 reduced at head dim 256 with tied embeddings (window,
global and window stages) and Mamba2 reduced (ssm), prefill and four
chained decode steps at prompts of 40 and 41 tokens in both kernel modes;
the embedding lookups bitwise; ``build_cache``'s layout against the
reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import embedding as jemb  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models.transformer import ModelContext as JCtx  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402
from test_torch_lm import _cfgs, check_prefill_and_decode  # noqa: E402


@pytest.mark.parametrize("S", [40, 41])
@pytest.mark.parametrize("kind", ["gemma3", "ssm"])
@pytest.mark.parametrize("mode", ["auto", "kernel"])
def test_prefill_and_decode_match_jax(kind, S, mode):
    check_prefill_and_decode(kind, S, mode)


@pytest.mark.parametrize("method", ["gather", "onehot", "rr"])
def test_embed_lookup_bitwise_equal_to_jax(method):
    rng = np.random.RandomState(1)
    table = rng.randn(256, 16).astype(np.float32)
    ids = rng.randint(0, 250, (3, 37)).astype(np.int32)
    ids[0, :5] = ids[1, :5]                   # repeated requests
    want = jemb.embed_lookup(jnp.asarray(table), jnp.asarray(ids), method)
    got = temb.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                            method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    uj, ij, nj = jemb.dedup_ids(jnp.asarray(ids.reshape(-1)), 111)
    ut, it, nt = temb.dedup_ids(torch.from_numpy(ids.reshape(-1)), 111)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(nt) == int(nj)


@pytest.mark.parametrize("kind", ["hybrid", "dense", "gemma3", "ssm"])
def test_build_cache_matches_jax_layout(kind):
    jcfg, tcfg = _cfgs(kind)
    want = jzoo.build_cache(jcfg, 3, 24, JCtx(mesh=None))
    got = tzoo.build_cache(tcfg, 3, 24, TCtx(), device="cpu")
    flat_j = jax.tree_util.tree_leaves(want)
    flat_t = jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: t, got, is_leaf=torch.is_tensor),
        is_leaf=torch.is_tensor)
    assert [a.shape for a in flat_j] == [tuple(t.shape) for t in flat_t]
    assert [str(a.dtype) for a in flat_j] == [
        str(t.dtype).replace("torch.", "") for t in flat_t]
    assert all(not t.any() for t in flat_t)
