"""Port: tensor parallelism's gradients, decode combine and checkpoints on
the (data, model) mesh.

Gradients.  Each rank's gradient of every leaf (its shard of a split
leaf, or the whole leaf) from ``make_train_step(...).grads`` on the mesh,
held to ``jax.grad`` of the JAX package's ``loss_fn`` jitted with
``param_specs`` / ``batch_specs`` shardings on its mesh (a subprocess with
4 forced host devices, Auto axis types), for reduced TinyLlama (dense: at
mp=4 the query heads split and the 2 kv heads stay whole, each read by
two ranks) and Hymba (hybrid: its attention, MLP and SSM split; ``wB`` /
``wC`` / ``conv_B`` / ``conv_C`` whole), on (1, 2) and (1, 4), in the
kernel route under remat "full".  A whole leaf that each rank uses for
its own heads only gets its gradient summed over the model group in
``_mesh_reduce``; without that sum (or with it twice) these leaves' rows
are off by a factor, far outside the tolerance.  Tolerances are
``test_torch_train.py``'s: the loss within rtol 1e-6, each leaf's
gradient within ``GRAD_RTOL`` = 3e-3 of its max.

The decode combine alone.  ``layers.decode_attention_split`` on 4 gloo
ranks, each holding 4 of 16 slots, against plain softmax attention over
the whole cache (float64 numpy): an early step whose valid keys all sit
in block 0 (the other blocks score only the finite NEG_INF and must weigh
0), a window that crosses a block edge, and a ring buffer after
wrap-around (slots holding positions out of order).  Within 1e-6 of the
output's max.

Checkpoints.  A train state placed by ``placement_specs`` on (2, 2) and
saved through ``save_gathered`` restores bit for bit without a mesh and
on (1, 1); a state saved without a mesh restores on (2, 2) and (1, 1),
its shards gathered back bit for bit.
"""
import dataclasses
import pickle
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_serve_mesh import ARCHS, run_both  # noqa: E402
from test_torch_train import GRAD_RTOL, LOSS_RTOL, batch_np  # noqa: E402

B, S = 4, 16
GRAD_MESHES = ((1, 2), (1, 4))
GRAD_ARCHS = ("tinyllama_1_1b", "hymba_1_5b")
COMBINE_RTOL = 1e-6

JAX_CODE = textwrap.dedent("""
    import os, sys, pickle, math, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig, get_config
    from repro.launch import shardings as sh
    from repro.models import model_zoo as zoo
    from repro.models.transformer import ModelContext
    with open(sys.argv[1], "rb") as f:
        rounds = pickle.load(f)["rounds"]
    keystr = jax.tree_util.keystr
    out = {}
    for _, cases in rounds:
        for case in cases:
            if case["kind"] != "grad":
                continue
            cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                                      **case["over"])
            shape = tuple(case["mesh"])
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:math.prod(shape)])
            ctx = ModelContext(mesh=mesh, remat="none", q_chunk=64)
            like = zoo.abstract_params(cfg, shape[1], jnp.float32)
            flat, tdef = jax.tree_util.tree_flatten_with_path(like)
            params = jax.tree_util.tree_unflatten(tdef, [
                jnp.asarray(case["params"][keystr(p)]) for p, _ in flat])
            b = case["batch"]
            cell = ShapeConfig("t", b["tokens"].shape[1],
                               b["tokens"].shape[0], "train")
            fn = jax.jit(jax.value_and_grad(
                lambda p, x: zoo.loss_fn(p, cfg, ctx, x)[0]),
                in_shardings=(sh.named(mesh, sh.param_specs(cfg, mesh, like)),
                              sh.named(mesh, sh.batch_specs(cfg, cell, mesh))))
            with mesh:
                loss, g = fn(params, jax.tree.map(jnp.asarray, b))
            out[case["name"]] = {"loss": float(loss), "grads": {
                keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(g)[0]}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), **ARCHS[arch])


def _flat(tree):
    return {p: t.detach().numpy() for p, t in ckpt._leaves_with_paths(tree)}


def grad_case(arch, mesh):
    cfg = _cfg(arch)
    params = tts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                  "cpu")["params"]
    return {"kind": "grad", "name": "%s-%dx%d" % (arch, *mesh),
            "arch": arch, "over": ARCHS[arch], "mesh": mesh,
            "kernels": "kernel", "remat": "full", "params": _flat(params),
            "batch": batch_np(cfg, seed=3, b=B, s=S)}


def _attend(q, k, v, valid, scale):
    """Plain softmax attention over the whole cache, float64: q (B, 1, H,
    hd), k / v (B, Sc, H, hd), valid (B, Sc)."""
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * scale
    s = np.where(valid[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def combine_case():
    """Three masks on a 16-slot cache split in 4 blocks of 4."""
    rng = np.random.RandomState(11)
    Bc, H, hd, Sc = 2, 4, 8, 16

    def arrays():
        return [rng.randn(*s).astype(np.float32) * 2 for s in
                ((Bc, 1, H, hd), (Bc, Sc, H, hd), (Bc, Sc, H, hd))]
    slots = np.arange(Sc)
    early = np.broadcast_to(slots <= 2, (Bc, Sc))            # block 0 only
    window = np.broadcast_to((slots <= 9) & (slots > 3), (Bc, Sc))
    # after wrap-around at pos 21 (window 16): slot s holds 16 + s for
    # s <= 5, else s; every slot valid, in ring order
    k_pos = np.where(slots <= 21 - 16, slots + 16, slots)
    ring = np.broadcast_to((k_pos <= 21) & (k_pos > 21 - 16), (Bc, Sc))
    inputs = {name: (*arrays(), np.ascontiguousarray(mask))
              for name, mask in (("early", early), ("window", window),
                                 ("ring", ring))}
    return {"kind": "combine", "name": "combine", "inputs": inputs,
            "scale": hd ** -0.5}


def ckpt_state():
    cfg = _cfg("hymba_1_5b")
    return _flat(tts.init_train_state(cfg, torch.Generator().manual_seed(4),
                                      "cpu"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_grad")
    state = ckpt_state()
    like = tts.init_train_state(_cfg("hymba_1_5b"),
                                torch.Generator().manual_seed(0), "cpu")
    whole = ckpt._unflatten(like, iter(
        [torch.from_numpy(state[p]) for p, _ in
         ckpt._leaves_with_paths(like)]))
    ckpt.save(str(tmp / "plain"), 1, whole)          # saved without a mesh
    common = {"kind": "ckpt", "arch": "hymba_1_5b",
              "over": ARCHS["hymba_1_5b"], "state": state}
    rounds = [
        (4, [grad_case(a, (1, 4)) for a in GRAD_ARCHS]
         + [combine_case(),
            dict(common, name="ckpt-2x2", mesh=(2, 2),
                 save=str(tmp / "mesh"), restore=[str(tmp / "plain")])]),
        (2, [grad_case(a, (1, 2)) for a in GRAD_ARCHS]),
        (1, [dict(common, name="ckpt-1x1", mesh=(1, 1),
                  restore=[str(tmp / "plain"), str(tmp / "mesh")])]),
    ]
    want, ranks = run_both(tmp, rounds, JAX_CODE)
    return {"want": want, "ranks": ranks, "state": state, "tmp": tmp,
            "like": like}


def _spec_paths(tree, prefix=""):
    """(keystr path, spec) of a spec tree's leaves (tuples)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


@pytest.mark.parametrize("mesh", GRAD_MESHES, ids=lambda m: "%dx%d" % m)
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_every_rank_gradient_matches_jax_grad(results, arch, mesh):
    """Every rank's gradient of every leaf, its shard cut from the
    reference's whole gradient by the placed specs."""
    name = "%s-%dx%d" % (arch, *mesh)
    want = results["want"][name]
    cfg = _cfg(arch)
    specs = dict(_spec_paths(sh.placement_specs(sh.param_specs(
        cfg, meshlib.Mesh(mesh, ("data", "model")),
        zoo.abstract_params(cfg, mesh[1])))))
    n_split = 0
    for r in range(mesh[0] * mesh[1]):
        got = results["ranks"][r][name]
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * want["loss"]
        m = meshlib.Mesh(mesh, ("data", "model"), rank=r)
        assert set(got["grads"]) == set(want["grads"])
        for path, g in got["grads"].items():
            w = want["grads"][path]
            block = w[sh._blocks(specs[path], w.shape, m, m.coords)]
            n_split += block.shape != w.shape
            assert _rel(g, block) <= GRAD_RTOL, (name, r, path)
    assert n_split > 0


def test_decode_combine_matches_whole_attention(results):
    case = combine_case()
    for name, (q, k, v, valid) in case["inputs"].items():
        want = _attend(q, k, v, valid, case["scale"])
        for r in range(4):
            got = results["ranks"][r]["combine"][name]
            assert np.isfinite(got).all(), (name, r)
            assert _rel(got, want) <= COMBINE_RTOL, (name, r)


def test_a_block_without_a_valid_key_weighs_nothing():
    """One rank alone (no group): a block whose slots are all invalid
    gives the finite uniform average, which the combine must drop: the
    early mask's blocks 1-3 differ from the answer, block 0 alone is it."""
    from repro_torch.models import layers
    case = combine_case()
    q, k, v, valid = case["inputs"]["early"]
    want = _attend(q, k, v, valid, case["scale"])
    got0 = layers.decode_attention_split(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (q, k[:, :4], v[:, :4], valid[:, :4])), case["scale"], None)
    assert _rel(got0.numpy(), want) <= COMBINE_RTOL
    got1 = layers.decode_attention_split(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (q, k[:, 4:8], v[:, 4:8], valid[:, 4:8])), case["scale"], None)
    assert np.isfinite(got1.numpy()).all()
    assert _rel(got1.numpy(), want) > 0.1


def _check_same(got: dict, want: dict):
    assert set(got) == set(want)
    for p, w in want.items():
        assert got[p].dtype == w.dtype and np.array_equal(got[p], w), p


def test_checkpoints_cross_meshes_bitwise(results):
    state, tmp, ranks = results["state"], results["tmp"], results["ranks"]
    plain, mesh = str(tmp / "plain"), str(tmp / "mesh")
    # saved on (2, 2) (its leaves gathered), read without a mesh
    restored, step = ckpt.restore(mesh, results["like"])
    assert step == 1
    _check_same(_flat(restored), state)
    # saved without a mesh: restored, placed on (2, 2) and on (1, 1),
    # gathered back; saved on (2, 2): restored on (1, 1)
    for r in range(4):
        _check_same(ranks[r]["ckpt-2x2"][plain], state)
    _check_same(ranks[0]["ckpt-1x1"][plain], state)
    _check_same(ranks[0]["ckpt-1x1"][mesh], state)
    # the (2, 2) placement held the rank's heads: 4 query heads, 2 a rank
    assert ranks[0]["ckpt-2x2"]["local_wq"][-2] == 2
    assert ranks[0]["ckpt-1x1"]["local_wq"][-2] == 4
