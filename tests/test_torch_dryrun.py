"""Port: the dry run of the production mesh (``launch.dryrun``: rank 0's
program on ``meta`` tensors in a fake world) against the reference's
sharding rules and against real ranks.

* (a) On a fake (2, 4) mesh, reduced TinyLlama (vocab 256): each cell's
  per-rank argument bytes (the train state, or the params and the cache,
  and the batch) equal what the reference's ``train_state_specs``
  (plain, zero1, fsdp), ``param_specs``, ``batch_specs`` and
  ``cache_specs`` imply for one device of the same mesh, part by part.
* (b) The counterpart of the reference's batch-sharding regression
  (``tests/test_dryrun_small.py``): no all-reduce of the step carries the
  full batch's (8, 32, d_model) activations; they all carry the data
  slice's (4, 32, d_model).
* (c) The collectives recorded in a fake world of 4 (kind, bytes, operand
  shapes and dtypes, group size, in order) equal what rank 0 of 4 real
  gloo CPU ranks records running the same (2, 2) step on real tensors
  (``_torch_dryrun_worker``: TinyLlama under the tensor-parallel
  placement, ZeRO-1 and fsdp, OLMoE under fsdp with stored experts),
  exactly; and the dry run's bytes of params and optimizer state equal
  the storages each real rank holds.
* (d) An MoE cell (reduced OLMoE, every shape kind; the production mesh's
  decode cell) and a ``"skipped"`` long_500k cell carry the reference's
  artifact keys and reason; the CLI writes one artifact a cell.
"""
import contextlib
import json
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

import _torch_dryrun_worker as worker  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models.transformer import ModelContext as JCtx  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402

SPAWN_TIMEOUT_S = 300
# the keys of the reference's artifact (repro/launch/dryrun.py)
OK_KEYS = {"arch", "shape", "mesh", "status", "options", "n_chips",
           "flops_per_chip", "hbm_bytes_per_chip", "collectives",
           "memory_analysis", "roofline", "timing"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops", "useful_ratio", "roofline_fraction"}
COLL_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute", "total"}
CELLS = {"train": ShapeConfig("t", 32, 8, "train"),
         "prefill": ShapeConfig("p", 32, 8, "prefill"),
         "decode": ShapeConfig("d", 64, 8, "decode")}


@contextlib.contextmanager
def fake_mesh(shape):
    with dryrun.fake_world(math.prod(shape)):
        yield meshlib.make_mesh(shape, ("data", "model"))


def tiny(arch="tinyllama_1_1b"):
    return tget(arch).reduced(), jget(arch).reduced()


def jbytes(tree, specs, sizes) -> int:
    """The bytes one device of a mesh of ``sizes`` (axis -> size) holds of
    a reference tree (``ShapeDtypeStruct``s) under its spec tree."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for d, size in enumerate(leaf.shape):
            e = tuple(spec)[d] if d < len(tuple(spec)) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            parts = math.prod(sizes[a] for a in axes)
            assert size % parts == 0
            n *= size // parts
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def reference_arguments(kind, shape_cfg, mesh_shape, **kw) -> dict:
    """The reference's per-device argument bytes of a (2, 4) cell, part by
    part, from its abstract trees and specs."""
    jcfg = tiny()[1]
    sizes = dict(zip(("data", "model"), mesh_shape))
    mesh = type("Stub", (), {"shape": sizes,
                             "axis_names": ("data", "model")})()
    mp = sizes["model"]
    shape = JShape(shape_cfg.name, shape_cfg.seq_len, shape_cfg.global_batch,
                   kind)
    inputs = jzoo.input_specs(jcfg, shape)
    out = {"batch": jbytes(inputs, jsh.batch_specs(jcfg, shape, mesh),
                           sizes)}
    if kind == "train":
        state = jts.abstract_train_state(jcfg, mp, jnp.bfloat16)
        specs = jsh.train_state_specs(jcfg, mesh, state, **kw)
        out["params"] = jbytes(state["params"], specs["params"], sizes)
        out["opt"] = jbytes(state["opt"], specs["opt"], sizes)
        return out
    params = jzoo.abstract_params(jcfg, mp, jnp.bfloat16)
    out["params"] = jbytes(params, jsh.param_specs(jcfg, mesh, params),
                           sizes)
    if kind == "decode":
        cache = jzoo.build_cache(jcfg, shape.global_batch, shape.seq_len,
                                 JCtx(), abstract=True)
        out["cache"] = jbytes(cache, jsh.cache_specs(jcfg, shape, mesh,
                                                     cache), sizes)
    return out


@pytest.mark.parametrize("kind,kw", [
    ("train", {}), ("train", {"zero1": True}), ("train", {"fsdp": True}),
    ("prefill", {}), ("decode", {})],
    ids=["train", "train-zero1", "train-fsdp", "prefill", "decode"])
def test_argument_bytes_equal_the_reference_specs(kind, kw):
    cfg = tiny()[0]
    with fake_mesh((2, 4)) as mesh:
        art = dryrun.run_cell(cfg, CELLS[kind], mesh, q_chunk=16, **kw)
    got = art["memory_analysis"]["arguments"]
    want = reference_arguments(kind, CELLS[kind], (2, 4), **kw)
    assert got == want
    assert art["memory_analysis"]["argument_size_in_bytes"] == sum(
        want.values())
    if kw:      # ZeRO-1 and fsdp hold less than the plain placement
        plain = reference_arguments(kind, CELLS[kind], (2, 4))
        assert got["opt"] < plain["opt"]


def test_batch_stays_sharded_through_the_step():
    cfg = tiny()[0]
    with fake_mesh((2, 4)) as mesh:
        art = dryrun.run_cell(cfg, CELLS["train"], mesh, q_chunk=16)
    d = cfg.d_model
    reduces = [op for op in art["ops"] if op["kind"] == "all-reduce"]
    assert reduces and art["collectives"]["all-reduce"]["count"] == len(
        reduces)
    shapes = [s for op in reduces for s in op["shapes"]]
    assert (8, 32, d) not in shapes
    assert (4, 32, d) in shapes
    assert art["flops_per_chip"] > 0 and art["hbm_bytes_per_chip"] > 0
    assert art["memory_analysis"]["temp_size_in_bytes"] > 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's record of ``worker.CASES`` on 4 gloo CPU ranks."""
    tmp = tmp_path_factory.mktemp("dryrun-ranks")
    spawn_ranks(worker.rank_main, (worker.WORLD, str(tmp / "store"),
                                   str(tmp / "out")), worker.WORLD,
                SPAWN_TIMEOUT_S)
    out = []
    for r in range(worker.WORLD):
        with open(tmp / f"out.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("case", worker.CASES)
def test_fake_world_records_rank_0s_collectives(ranks, case):
    cfg, step_cfg, flags = worker.case_config(case)
    with fake_mesh(worker.MESH) as mesh:
        art = dryrun.run_cell(cfg, worker.SHAPE, mesh, dtype=torch.float32,
                              step_cfg=step_cfg, **flags)
    want = ranks[0][case]["ops"]
    assert want, "the step called no collective"
    assert art["ops"] == want
    kinds = {op["kind"] for op in want}
    if flags.get("zero1"):
        assert {"reduce-scatter", "all-gather"} <= kinds
    if cfg.is_moe:
        assert "all-to-all" in kinds
    args = art["memory_analysis"]["arguments"]
    for r in ranks:
        assert r[case]["bytes"] == {"params": args["params"],
                                    "opt": args["opt"]}


@pytest.mark.parametrize("kind", list(CELLS))
def test_moe_cells_run_on_meta(kind):
    cfg = tiny("olmoe_1b_7b")[0]
    with fake_mesh((2, 4)) as mesh:
        art = dryrun.run_cell(cfg, CELLS[kind], mesh, q_chunk=16)
    assert set(art["collectives"]) == COLL_KEYS
    assert set(art["roofline"]) == ROOFLINE_KEYS
    assert art["collectives"]["all-to-all"]["count"] > 0
    assert art["flops_per_chip"] > 0


def test_production_cells_carry_the_reference_keys(tmp_path):
    art = dryrun.lower_cell("olmoe_1b_7b", "decode_32k", False)
    assert art["status"] == "ok" and OK_KEYS <= set(art)
    assert art["n_chips"] == 256 and art["mesh"] == "16x16"
    assert set(art["roofline"]) == ROOFLINE_KEYS
    assert set(art["collectives"]) == COLL_KEYS
    assert {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"} <= set(art["memory_analysis"])
    json.dumps(art)
    skipped = dryrun.lower_cell("tinyllama_1_1b", "long_500k", True)
    ok, why = jget("tinyllama_1_1b").shape_supported(JSHAPES["long_500k"])
    assert not ok
    assert skipped == {"arch": "tinyllama_1_1b", "shape": "long_500k",
                       "mesh": "2x16x16", "status": "skipped",
                       "reason": why}
    assert dryrun.main(["--arch", "tinyllama_1_1b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    written = json.loads((tmp_path / "tinyllama_1_1b.long_500k.16x16.json")
                         .read_text())
    assert written["status"] == "skipped" and written["reason"] == why


def test_roofline_of_a_cell_uses_the_cards_figures():
    from repro_torch.launch import roofline
    cfg = tiny()[0]
    with fake_mesh((2, 4)) as mesh:
        art = dryrun.run_cell(cfg, CELLS["prefill"], mesh, q_chunk=16)
    r = art["roofline"]
    assert r["compute_s"] == art["flops_per_chip"] / roofline.PEAK_FLOPS
    assert r["memory_s"] == art["hbm_bytes_per_chip"] / roofline.HBM_BW
    # the (2, 4) mesh's 8 ranks lie in one node: NVLink
    assert r["collective_s"] == (art["collectives"]["total"]["bytes"]
                                 / roofline.NVLINK_BW)
    assert np.isfinite(r["roofline_fraction"])
