"""Port: the vocab-sharded lookup and loss of the training mesh
(``embed_lookup_sharded``, ``logits_matmul`` / ``softmax_xent`` on a mesh)
against the JAX package's ``embed_lookup_sharded`` (``shard_map`` under
``jax.set_mesh``, its gradient through ``jax.jit(jax.grad(...))``) and
``softmax_xent``, run in one subprocess with 4 forced host devices.

The ids are ``SyntheticLM``'s Zipf tokens (vocab 256, 4 x 32): each data
worker's slice repeats ids, so the dedup matters.  The port runs on gloo
ranks (``tests/_torch_train_mesh_worker.py``, no JAX) on the meshes
(1, 1), (2, 1), (1, 2), (2, 2) and (1, 4), each a group of its own world
size.

Tolerances.  The lookup's output equal bit for bit (each response row is
one table row, exactly; the reference's one-hot product is exact too).
Its table gradient sums the repeated ids' cotangents in another order
(``index_add`` here, the one-hot product's transpose there): within
``GRAD_RTOL`` = 1e-6 of the gradient's max.  The loss within rtol 1e-6 and
its gradients within 1e-6 of their max: the vocab reductions (the max,
the sum of exponentials, the label's logit) meet across shards in another
order.  U, each worker's distinct ids, equals ``token_stats`` of its
slice.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train_mesh_worker as worker  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402
from repro_torch.models import embedding as emb  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
V, D, B, S = 256, 16, 4, 32
MESHES = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
GRAD_RTOL = 1e-6
LOSS_RTOL = 1e-6
SPAWN_TIMEOUT_S = 300

JAX_CODE = textwrap.dedent("""
    import os, sys, pickle, math
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.embedding import (embed_lookup_sharded, logits_matmul,
                                        softmax_xent)
    with open(sys.argv[1], "rb") as f:
        rounds = pickle.load(f)["rounds"]
    out = {}
    for _, cases in rounds:
        for c in cases:
            shape = tuple(c["mesh"])
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 devices=jax.devices()[:math.prod(shape)])
            table, ids, cot = (jnp.asarray(c[k]) for k in
                               ("table", "ids", "cot"))
            with jax.set_mesh(mesh):
                look = jax.jit(lambda t: embed_lookup_sharded(
                    t, ids, mesh, ("data",), "model"))
                grad = jax.jit(jax.grad(lambda t: jnp.sum(
                    embed_lookup_sharded(t, ids, mesh, ("data",), "model")
                    * cot)))
                res = {"out": np.asarray(look(table)),
                       "grad": np.asarray(grad(table))}
            loss, (gh, gt) = jax.jit(jax.value_and_grad(
                lambda h, t: softmax_xent(logits_matmul(h, t),
                                          jnp.asarray(c["labels"]),
                                          jnp.asarray(c["mask"])),
                argnums=(0, 1)))(jnp.asarray(c["h"]), table)
            res.update(loss=float(loss), grad_h=np.asarray(gh),
                       grad_table=np.asarray(gt))
            out[c["name"]] = res
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _inputs() -> dict:
    ids = tdata.SyntheticLM(tdata.DataConfig(vocab=V, seq_len=S,
                                             global_batch=B)).batch_at(3)[
        "tokens"]
    rng = np.random.RandomState(7)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    return {"table": rng.randn(V, D).astype(np.float32),
            "ids": ids, "cot": rng.randn(B, S, D).astype(np.float32),
            "h": rng.randn(B, S, D).astype(np.float32),
            "labels": np.concatenate([ids[:, 1:], ids[:, :1]], axis=1),
            "mask": mask}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """({case: the reference's}, {case: [rank 0's, ...]})."""
    tmp = tmp_path_factory.mktemp("embed_sharded")
    x = _inputs()
    rounds = [(w, [dict(x, kind="embed", name="%dx%d" % m, mesh=m)
                     for m in meshes]) for w, meshes in MESHES.items()]
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump({"rounds": rounds}, f)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(tmp / "spec.pkl"),
         str(tmp / "jax.pkl")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"))
    try:
        spawn_ranks(worker.rank_main, (str(tmp), str(tmp / "spec.pkl"),
                                       str(tmp / "out")), worker.WORLD,
                    SPAWN_TIMEOUT_S)
    finally:
        _, err = jax_run.communicate(timeout=SPAWN_TIMEOUT_S)
    assert jax_run.returncode == 0, err[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    ranks = []
    for r in range(worker.WORLD):
        with open(tmp / f"out.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return want, ranks


def _rel(got, want):
    assert got.shape == want.shape
    return float(np.max(np.abs(got.astype(np.float64) - want))
                 / np.max(np.abs(want)))


MESH_IDS = ["%dx%d" % m for ms in MESHES.values() for m in ms]


@pytest.mark.parametrize("name", MESH_IDS)
def test_lookup_bitwise_and_table_gradient(both, name):
    want, ranks = both
    got = ranks[0][name]
    np.testing.assert_array_equal(got["out"], want[name]["out"])
    assert _rel(got["grad"], want[name]["grad"]) <= GRAD_RTOL


@pytest.mark.parametrize("name", MESH_IDS)
def test_each_worker_dedups_its_own_slice(both, name):
    """U of every rank's worker equals token_stats of its slice (the
    per-worker request set of §6), and the dedup saves requests."""
    _, ranks = both
    dp, mp = (int(n) for n in name.split("x"))
    b = B // dp
    ids = _inputs()["ids"]
    for r in range(dp * mp):
        got = ranks[r][name]
        d = r // mp
        want = tdata.token_stats(ids[d * b:(d + 1) * b])
        assert got["stats"] == want
        assert (got["unique"], got["tokens"]) == (want["unique"], b * S)
        assert got["unique"] < got["tokens"]


@pytest.mark.parametrize("name", MESH_IDS)
def test_vocab_sharded_loss_and_gradients(both, name):
    want, ranks = both
    dp, mp = (int(n) for n in name.split("x"))
    losses = {ranks[r][name]["loss"] for r in range(dp * mp)}
    assert len(losses) == 1        # replicated over the whole mesh
    got = ranks[0][name]
    assert abs(got["loss"] - want[name]["loss"]) <= LOSS_RTOL * abs(
        want[name]["loss"])
    assert _rel(got["grad_h"], want[name]["grad_h"]) <= GRAD_RTOL
    assert _rel(got["grad_table"], want[name]["grad_table"]) <= GRAD_RTOL


def test_refusals():
    """Uneven shardings (the reference's fallback) raise, naming both
    sizes; a lookup the mesh does not shard, a mesh beside an MoE context,
    unknown axes, a mesh without its process group and a decode step on
    the mesh without its cache's context raise too."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.moe import MoEContext
    from repro_torch.models.transformer import ModelContext
    mesh = meshlib.Mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="batch 3, vocab 256"):
        emb.check_shardable(3, 256, mesh)
    with pytest.raises(ValueError, match="batch 4, vocab 250"):
        emb.check_shardable(4, 250, mesh)
    emb.check_shardable(4, 256, mesh)
    with pytest.raises(ValueError, match="EP group"):
        ModelContext(mesh=mesh, moe=MoEContext(ep_group=None))
    with pytest.raises(ValueError, match="not the mesh"):
        ModelContext(mesh=mesh, dp_axes=("pod", "data"))
    with pytest.raises(ValueError, match="training mesh's axes"):
        meshlib.Mesh((2, 2), ("h", "w"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        meshlib.make_mesh((1, 1), ("data", "model"))
    cfg = get_config("tinyllama_1_1b").reduced()
    one = meshlib.Mesh((1, 1), ("data", "model"))
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="'rr'"):
        zoo.forward_logits(params, cfg, ModelContext(
            mesh=one, embed_method="gather"), toks)
    # serving on the mesh: decode_step needs the context its cache was
    # placed for; on the (1, 1) mesh (no collective runs) the prefill is
    # the one-device prefill, bit for bit
    logits, cache = zoo.prefill(params, cfg, ModelContext(mesh=one), toks,
                                max_len=8)
    want, _ = zoo.prefill(params, cfg, ModelContext(), toks, max_len=8)
    assert torch.equal(logits, want)
    with pytest.raises(ValueError, match="needs max_len"):
        zoo.decode_step(params, cfg, ModelContext(mesh=one), toks[:, :1],
                        cache)
