"""Port: the sharding rules of the training mesh (``launch.shardings``)
and the abstract trees against the JAX package's.

Every spec of ``param_specs``, ``train_state_specs`` (plain, zero1,
fsdp), ``batch_specs``, ``logits_spec`` and ``cache_specs``, for all 10
architectures at full size, every shape cell of ``SHAPES`` and the meshes
(2, 4), (16, 16) and (2, 16, 16), equals ``tuple()`` of the reference's
``PartitionSpec``, leaf by leaf: the rules need only ``mesh.shape`` and
``mesh.axis_names``, so both sides get the same stub mesh and nothing is
allocated (the port's abstract trees live on the ``meta`` device, the
reference's are ``ShapeDtypeStruct``s).  ``abstract_params`` and
``abstract_train_state`` give the reference's shapes and dtypes.  Then
``shard_tree`` on every rank of a mesh and ``assemble`` give each leaf
back (a placed train state too), and ``placement_specs`` keeps the
reference's train state specs whole (plain, zero1, fsdp): the batch's
data axes, the vocab rows, the tensor-parallel and expert ``model``
entries and the optimizer's and fsdp's data axes.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models.transformer import ModelContext as JCtx  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import shardings as tsh  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def stub(shape):
    axes = MESHES[shape]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def jflat(specs, tree=None):
    """{path names: tuple(spec)} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jsh._path_names(p): tuple(s) for p, s in leaves}


def tflat(specs, tree):
    """{path names: spec} of a port spec tree, walked along ``tree``."""
    out = {}
    tsh._zip(tree, specs, lambda path, leaf, spec: out.setdefault(path,
                                                                  spec))
    return out


def _same(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, (what, list(bad.items())[:5])
    return len(want)


@pytest.mark.parametrize("mesh_shape", list(MESHES),
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_spec_matches_jax(arch, mesh_shape):
    jcfg, tcfg = jget(arch), tget(arch)
    mesh = stub(mesh_shape)
    mp = mesh.shape["model"]
    jstate = jts.abstract_train_state(jcfg, mp)
    tstate = tts.abstract_train_state(tcfg, mp)
    n = _same(tflat(tsh.param_specs(tcfg, mesh, tstate["params"]),
                    tstate["params"]),
              jflat(jsh.param_specs(jcfg, mesh, jstate["params"])), "params")
    for kw in ({}, {"zero1": True}, {"fsdp": True}):
        n += _same(tflat(tsh.train_state_specs(tcfg, mesh, tstate, **kw),
                         tstate),
                   jflat(jsh.train_state_specs(jcfg, mesh, jstate, **kw)),
                   kw)
    for name, shape in SHAPES.items():
        tshape = TSHAPES[name]
        n += _same(tsh.batch_specs(tcfg, tshape, mesh),
                   {k: tuple(v) for k, v in
                    jsh.batch_specs(jcfg, shape, mesh).items()}, name)
        assert tsh.logits_spec(tcfg, tshape, mesh) == tuple(
            jsh.logits_spec(jcfg, shape, mesh))
        B, S = shape.global_batch, shape.seq_len
        jcache = jzoo.build_cache(jcfg, B, S, JCtx(), abstract=True)
        tcache = tzoo.build_cache(tcfg, B, S, TCtx(), device="meta")
        n += 1 + _same(tflat(tsh.cache_specs(tcfg, tshape, mesh, tcache),
                             tcache),
                       jflat(jsh.cache_specs(jcfg, shape, mesh, jcache)),
                       name)
    assert n > 100


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("mp", [1, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_matches_jax(arch, mp):
    jstate = jts.abstract_train_state(jget(arch), mp)
    tstate = tts.abstract_train_state(tget(arch), mp)
    want = {jsh._path_names(p): (tuple(v.shape), _dtype(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    got = {}
    tsh._walk(tstate, lambda path, t: got.setdefault(
        path, (tuple(t.shape), _dtype(t))))
    assert got == want
    assert all(t.device.type == "meta" for t in tts.tree_leaves(tstate))
    # the float32 leaves are the reference's _NO_INIT_SCALE family
    f32 = {p[-1] for p, (_, dt) in got.items()
           if dt == "float32" and p[0] == "params"}
    assert f32 <= set(jzoo._NO_INIT_SCALE) and "final_norm" in f32


def test_param_shapes_take_the_model_axis():
    cfg = tget("whisper_medium")            # vocab 51,865
    assert tzoo.param_shapes(cfg)["embed"][0] == jzoo.param_shapes(
        jget("whisper_medium"))["embed"][0] == 51968
    for mp in (1, 16, 256):
        assert tzoo.param_shapes(cfg, mp)["embed"] == tuple(
            jzoo.param_shapes(jget("whisper_medium"), mp)["embed"])
    assert tzoo.param_shapes(cfg, 256)["embed"][0] % 256 == 0


SHARD_MESHES = [((2, 4), ("data", "model")),
                ((2, 2, 2), ("pod", "data", "model")),
                ((1, 4), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", SHARD_MESHES,
                         ids=lambda x: "x".join(map(str, x)))
def test_shard_tree_and_assemble_round_trip(shape, axes):
    rng = np.random.RandomState(0)
    tree = {"embed": torch.from_numpy(rng.randn(16, 6).astype(np.float32)),
            "stages": [{"w": torch.from_numpy(rng.randn(3, 8, 4, 2)
                                              .astype(np.float32))}],
            "norm": torch.from_numpy(rng.randn(5).astype(np.float32))}
    dp = tuple(a for a in axes if a != "model")
    specs = {"embed": ("model", None),
             "stages": [{"w": (None, dp if len(dp) > 1 else dp[0], "model",
                               None)}],
             "norm": (None,)}
    ranks = [meshlib.Mesh(shape, axes, rank=r)
             for r in range(int(np.prod(shape)))]
    parts = [tsh.shard_tree(tree, specs, m) for m in ranks]
    assert parts[0]["norm"] is tree["norm"]          # replicated: as it is
    mp = dict(zip(axes, shape))["model"]
    assert parts[0]["embed"].shape == (16 // mp, 6)
    for get in (lambda t: t["embed"], lambda t: t["stages"][0]["w"]):
        spec = get(specs)
        whole = tsh.assemble([get(p) for p in parts], spec, ranks[0])
        assert torch.equal(whole, get(tree))
    with pytest.raises(ValueError, match="does not split"):
        tsh.shard_tree({"x": torch.zeros(3, 2)}, {"x": ("model", None)},
                       ranks[-1])


PLACEMENTS = {"plain": {}, "zero1": {"zero1": True}, "fsdp": {"fsdp": True}}


@pytest.mark.parametrize("placement", list(PLACEMENTS))
@pytest.mark.parametrize("mp", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_specs_keep_the_batch_and_the_vocab_rows(arch, mp,
                                                            placement):
    """Every leaf of the train state placed on a ("pod", "data", "model")
    mesh of model size ``mp`` (plain, zero1 or fsdp): the reference's
    ``train_state_specs`` spec, entry for entry (params and the
    optimizer's master, m and v alike): the vocab rows, the ``model``
    entries of the leaves under ``attn``, ``cross``, ``mlp`` and ``ssm``
    and of the routed expert stacks (stored expert shards; the router and
    the mirrored experts whole), and the data axes that ZeRO-1 puts on
    the optimizer state and fsdp on the parameters too, which
    ``data_leaves`` names with their dimension.  ``model_leaves`` puts
    the expert stacks with the split leaves and the router and mirrors
    with those summed over the model group.  The batch keeps its data
    axes."""
    kw = PLACEMENTS[placement]
    cfg = tget(arch)
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": mp},
                                 axis_names=("pod", "data", "model"))
    state = tts.abstract_train_state(cfg, mp)
    specs = tsh.placement_specs(tsh.train_state_specs(cfg, mesh, state,
                                                      **kw))
    flat = tflat(specs, state)
    want_all = jflat(jsh.train_state_specs(
        jget(arch), mesh, jts.abstract_train_state(jget(arch), mp), **kw))
    assert _same(flat, want_all, placement) > 0
    n_model = n_data = 0
    for path, spec in flat.items():
        n_model += any("model" in tsh._axes(e) for e in spec)
        dims = [d for d, e in enumerate(spec) if "data" in tsh._axes(e)]
        n_data += bool(dims)
        assert len(dims) <= 1 and all(
            spec[d] == ("pod", "data") for d in dims), (path, spec)
        if path[0] == "opt" and path[1] != "step":
            # master, m and v: the params' spec, data axes as placed
            p = flat[("params",) + path[2:]]
            assert spec == p or (placement == "zero1" and tuple(
                None if d in dims else e for d, e in enumerate(spec)) == p)
    assert n_model > 0
    assert (n_data > 0) == (placement != "plain")
    data = tsh.data_leaves(specs["opt"]["master"])
    assert data == {k[2:]: d for k, d in tsh.data_leaves(specs).items()
                    if k[:2] == ("opt", "master")}
    assert bool(tsh.data_leaves(specs["params"])) == (placement == "fsdp")
    split, partial = tsh.model_leaves(specs["params"])
    if cfg.is_moe and cfg.moe.n_experts % mp == 0:
        moe = [p for p in split | partial if "moe" in p]
        assert {p[-1] for p in moe if p in split} == {
            "w_gate", "w_up", "w_down"}
        assert {p[-1] for p in moe if p in partial} == {
            "router", "w_gate_m", "w_up_m", "w_down_m"}
    batch = tsh.placement_specs(tsh.batch_specs(cfg, TSHAPES["train_4k"],
                                                mesh))
    want = {"tokens": (("pod", "data"), None)}
    if cfg.enc_dec:
        want["enc_embeds"] = (("pod", "data"), None, None)
    assert batch == want


@pytest.mark.parametrize("placement", list(PLACEMENTS))
@pytest.mark.parametrize("shape,axes", SHARD_MESHES,
                         ids=lambda x: "x".join(map(str, x)))
def test_shard_tree_and_assemble_round_trip_a_placed_state(shape, axes,
                                                          placement):
    """A reduced OLMoE train state (stored experts, and the data axes of
    ZeRO-1 / fsdp on the layer axis or an inner one) cut by
    ``shard_tree`` on every rank of the mesh: each block of
    ``local_shape`` in a storage of its own (a block on the layer axis is
    a contiguous slice, which must not keep the whole leaf alive), and
    ``assemble`` gives every leaf back."""
    cfg = tget("olmoe_1b_7b").reduced()
    mesh0 = meshlib.Mesh(shape, axes)
    state = tts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                 "cpu", model_parallel=mesh0.model_size)
    specs = tsh.placement_specs(tsh.train_state_specs(
        cfg, mesh0, tts.abstract_train_state(cfg, mesh0.model_size),
        **PLACEMENTS[placement]))
    ranks = [meshlib.Mesh(shape, axes, rank=r)
             for r in range(int(np.prod(shape)))]
    parts = [tsh.shard_tree(state, specs, m) for m in ranks]
    leaves = []
    tsh._zip(state, specs, lambda path, leaf, spec: leaves.append(
        (path, leaf, spec)))
    n_split = 0
    for i, (path, leaf, spec) in enumerate(leaves):
        blocks = [tts.tree_leaves(p)[i] for p in parts]
        split = tuple(blocks[0].shape) != tuple(leaf.shape)
        for m, b in zip(ranks, blocks):
            assert tuple(b.shape) == tsh.local_shape(spec, leaf.shape, m)
            if split:       # a block of its own, not a view of the leaf
                assert b.untyped_storage().nbytes() == \
                    b.numel() * b.element_size(), path
        n_split += split
        assert torch.equal(tsh.assemble(blocks, spec, ranks[0]), leaf), path
    assert n_split > 0


def test_placement_specs_refuse_a_split_the_port_does_not_run():
    """A model entry on a leaf that the port holds whole (a norm, the
    router) raises rather than being dropped to a replicated leaf."""
    ok = {"embed": ("model", "data"), "moe": {"w_up": (None, "model", None)}}
    assert tsh.placement_specs(ok) == ok
    for bad in ({"final_norm": ("model",)},
                {"moe": {"router": (None, None, "model")}}):
        with pytest.raises(NotImplementedError, match="model axis"):
            tsh.placement_specs(bad)
