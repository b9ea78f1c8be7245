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
back, and ``placement_specs`` keeps exactly the batch's data axes, the
vocab rows and the tensor-parallel ``model`` entries of the attention,
MLP and SSM leaves.
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


@pytest.mark.parametrize("mp", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placement_specs_keep_the_batch_and_the_vocab_rows(arch, mp):
    """Every leaf of the zero1 train state on a ("pod", "data", "model")
    mesh of model size ``mp``: the vocab rows, and the ``model`` entries
    of the reference's ``param_spec_for`` for the leaves under ``attn``,
    ``cross``, ``mlp`` and ``ssm`` (params and the optimizer's master, m
    and v alike); every other entry None (the experts, ZeRO-1's data
    axes).  The batch keeps its data axes."""
    cfg = tget(arch)
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": mp},
                                 axis_names=("pod", "data", "model"))
    state = tts.abstract_train_state(cfg, mp)
    specs = tsh.placement_specs(tsh.train_state_specs(cfg, mesh, state,
                                                      zero1=True))
    flat = tflat(specs, state)
    n_model = 0
    for path, spec in flat.items():
        leaf = state
        for k in path:
            leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
        want = tuple(jsh.param_spec_for(path, tuple(leaf.shape), jget(arch),
                                        mp)) if path != ("opt", "step") \
            else ()
        if path[-1] in ("embed", "out_embed") or (
                len(path) >= 2 and path[-2] in ("attn", "cross", "mlp",
                                                 "ssm")):
            want = tuple(e if e == "model" else None for e in want)
        else:
            want = (None,) * len(want)
        assert spec == want, (path, spec, want)
        n_model += "model" in spec
    assert n_model > 0
    batch = tsh.placement_specs(tsh.batch_specs(cfg, TSHAPES["train_4k"],
                                                mesh))
    want = {"tokens": (("pod", "data"), None)}
    if cfg.enc_dec:
        want["enc_embeds"] = (("pod", "data"), None, None)
    assert batch == want
