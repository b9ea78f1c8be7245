"""Port: ``prefill`` and ``decode_step`` on the (data, model) mesh over
``torch.distributed`` against the JAX package's ``make_prefill_step`` /
``make_decode_step`` jitted on its mesh.

The params are placed by ``placement_specs`` (the attention, MLP and SSM
leaves split over the model axis wherever ``param_spec_for`` splits them,
the vocab rows of ``embed`` / ``out_embed``), the cache by ``cache_specs``
(the batch over the data axis, the cache's sequence axis over the model
axis, or over every axis where the batch does not split) and the logits
by ``logits_spec``.  The reference runs in a subprocess with 4 forced host
devices: ``jax.make_mesh`` with Auto axis types, the steps jitted with
``param_specs`` / ``batch_specs`` in-shardings and ``logits_spec`` /
``cache_specs`` out-shardings under ``with mesh``.  The port runs on
spawned gloo ranks (``tests/_torch_serve_mesh_worker.py``, no JAX) in the
kernel route (the kernels' wrappers, whose CPU forward is the plain
version): rank 0 gathers the logits after the prefill and after each
decode step and the cache after the last step.

B=4 prompts of S=16 tokens, then 3 decode steps fed the same ids on both
sides, at max_len 24 (every stage's cache length splits over 2 and 4).
This file: reduced TinyLlama (dense; mp=4 splits its 4 query heads but
not its 2 kv heads) and Mamba2 (ssm) on (1, 2), (2, 2) and (1, 4); one
B=1 case on (2, 2), where the batch does not split over the data axis and
``cache_specs`` puts the cache's sequence over both axes; one case at
max_len 19 on (1, 2), where the global stage's cache length does not split
and decode attends the whole local cache.  Hymba and Gemma-3 are in
``test_torch_serve_mesh_more.py``, OLMoE and Whisper in
``test_torch_serve_mesh_moe.py`` (each file has its own reference
subprocess and spawn).

Tolerances are ``test_torch_lm.py``'s: the prefill logits within
``LOGIT_RTOL`` = 1e-4 of max|logit|, the chained decode steps' within
``CHAIN_RTOL`` = 1e-3, every cache leaf within ``CACHE_RTOL`` = 1e-4 of its
max, ``k_pos`` and ``pos`` exact.  The reference's own mesh steps reorder
float32 sums too (against its one-device steps by at most 1.9e-5 of the
logits for the decoder-only kinds and 9.3e-5 for Whisper).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_serve_mesh_worker as worker  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS, MAX_LEN = 4, 16, 3, 24
MESHES = ((1, 2), (2, 2), (1, 4))
SPAWN_TIMEOUT_S = 300
LOGIT_RTOL = 1e-4
CHAIN_RTOL = 1e-3
CACHE_RTOL = 1e-4
ARCHS = {
    "tinyllama_1_1b": {},
    "mamba2_1_3b": {},
    "hymba_1_5b": dict(n_layers=3, global_every=2),
    "gemma3_4b": dict(n_layers=3, global_every=2, tie_embeddings=True),
    "olmoe_1b_7b": {},
    "whisper_medium": {},
}

JAX_CODE = textwrap.dedent("""
    import os, sys, pickle, math, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding
    from repro.configs.base import ShapeConfig, get_config
    from repro.launch import shardings as sh
    from repro.models import model_zoo as zoo
    from repro.models.transformer import ModelContext
    from repro.train.train_step import make_decode_step, make_prefill_step
    with open(sys.argv[1], "rb") as f:
        rounds = pickle.load(f)["rounds"]
    keystr = jax.tree_util.keystr
    out = {}
    for _, cases in rounds:
        for case in cases:
            over = dict(case["over"])
            ssm = over.pop("ssm", None)
            cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                                      **over)
            if ssm is not None:
                cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                    cfg.ssm, **ssm))
            shape = tuple(case["mesh"])
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:math.prod(shape)])
            ctx = ModelContext(mesh=mesh, remat="none", q_chunk=64)
            like = zoo.abstract_params(cfg, shape[1], jnp.float32)
            flat, tdef = jax.tree_util.tree_flatten_with_path(like)
            params = jax.tree_util.tree_unflatten(tdef, [
                jnp.asarray(case["params"][keystr(p)]) for p, _ in flat])
            B, S = case["tokens"].shape
            L = case["max_len"]
            cell = ShapeConfig("serve", S, B, "prefill")
            pspecs = sh.named(mesh, sh.param_specs(cfg, mesh, like))
            cspecs = sh.named(mesh, sh.cache_specs(
                cfg, cell, mesh, zoo.build_cache(cfg, B, L, ctx,
                                                 abstract=True)))
            lspec = NamedSharding(mesh, sh.logits_spec(cfg, cell, mesh))
            tspec = NamedSharding(mesh, sh.batch_specs(
                cfg, ShapeConfig("serve", 1, B, "decode"), mesh)["token"])
            prefill = jax.jit(make_prefill_step(cfg, ctx, L),
                              in_shardings=(pspecs, sh.named(
                                  mesh, sh.batch_specs(cfg, cell, mesh))),
                              out_shardings=(lspec, cspecs))
            decode = jax.jit(make_decode_step(cfg, ctx),
                             in_shardings=(pspecs, tspec, cspecs),
                             out_shardings=(lspec, cspecs))
            batch = {"tokens": jnp.asarray(case["tokens"])}
            if "enc_embeds" in case:
                batch["enc_embeds"] = jnp.asarray(case["enc_embeds"])
            with mesh:
                lg, cache = prefill(params, batch)
                logits = [np.asarray(lg)]
                for tok in case["steps"]:
                    lg, cache = decode(params, jnp.asarray(tok), cache)
                    logits.append(np.asarray(lg))
            out[case["name"]] = {"logits": logits, "cache": {
                keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(cache)[0]}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def serve_case(arch, mesh, b=B, max_len=MAX_LEN, over=None, tag=""):
    """A case of the worker's ``serve`` kind: params drawn by the port's
    init recipe from ``torch.Generator(0)`` (keystr -> numpy; both sides
    serve them), prompts and decode ids drawn with numpy; ``over``
    replaces the config's fields (ARCHS[arch] by default)."""
    over = ARCHS[arch] if over is None else over
    cfg = worker.reduced(get_config, arch, over)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(7)
    case = {"kind": "serve", "name": "%s%s-%dx%d-b%d-l%d" % (
                arch, tag, *mesh, b, max_len),
            "arch": arch, "over": over, "mesh": mesh,
            "kernels": "kernel", "max_len": max_len,
            "params": {p: t.numpy() for p, t in
                       ckpt._leaves_with_paths(params)},
            "tokens": rng.randint(0, cfg.vocab, (b, S)).astype(np.int32),
            "steps": [rng.randint(0, cfg.vocab, (b, 1)).astype(np.int32)
                      for _ in range(STEPS)]}
    if cfg.enc_dec:
        case["enc_embeds"] = rng.randn(b, cfg.enc_seq,
                                       cfg.d_model).astype(np.float32)
    return case


def rounds_of(cases):
    """The cases grouped into rounds by their mesh's size."""
    by = {}
    for c in cases:
        by.setdefault(c["mesh"][0] * c["mesh"][1], []).append(c)
    return sorted(by.items(), reverse=True)


def run_both(tmp: Path, rounds, jax_code=JAX_CODE) -> tuple:
    """(the reference's results, rank 0's) for every case of ``rounds``,
    the two sides run at the same time."""
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump({"rounds": rounds}, f)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", jax_code, str(tmp / "spec.pkl"),
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
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


def check_serve(case, want, got):
    """Rank 0's logits of each call and its gathered cache against the
    reference's; the cache really split as ``cache_specs`` says."""
    cfg = worker.reduced(get_config, case["arch"], case["over"])
    V = cfg.vocab
    assert len(got["logits"]) == len(want["logits"]) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_array_equal(g[:, V:], w[:, V:])
        rtol = LOGIT_RTOL if i == 0 else CHAIN_RTOL
        assert _rel(g[:, :V], w[:, :V]) <= rtol, (case["name"], i)
    assert set(got["cache"]) == set(want["cache"])
    for key, w in want["cache"].items():
        g = got["cache"][key]
        if "k_pos" in key or key == "['pos']":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert _rel(g, w) <= CACHE_RTOL, (case["name"], key)
    b = case["tokens"].shape[0]
    dp, mp = case["mesh"]
    specs = zoo.cache_placement(cfg, b, case["max_len"], worker.meshlib.Mesh(
        case["mesh"], ("data", "model")))
    slots = []
    for i, sp in enumerate(specs["stages"]):
        if "k" in sp:
            parts = {None: 1, "model": mp}.get(sp["k"][2], dp * mp)
            slots.append(want["cache"][f"['stages'][{i}]['k']"].shape[2]
                         // parts)
    assert [k[2] for k in got["local_k"]] == slots, case["name"]


def results_for(tmp, cases):
    want, ranks = run_both(tmp, rounds_of(cases))
    return {c["name"]: (c, want[c["name"]], ranks[0][c["name"]])
            for c in cases}


MAIN = [serve_case(a, m) for a in ("tinyllama_1_1b", "mamba2_1_3b")
        for m in MESHES]
EDGE = [serve_case("tinyllama_1_1b", (2, 2), b=1),
        serve_case("tinyllama_1_1b", (1, 2), max_len=19)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return results_for(tmp_path_factory.mktemp("serve_mesh"), MAIN + EDGE)


@pytest.mark.parametrize("name", [c["name"] for c in MAIN])
def test_serving_on_the_mesh_matches_jax(results, name):
    check_serve(*results[name])


def test_one_sequence_splits_the_cache_over_every_axis(results):
    """B=1 on (2, 2): the batch does not split over the data axis, so
    every stage's cache sequence is split over (data, model), four blocks
    of 6 slots, and the decode combines the softmax over all four ranks."""
    case, want, got = results["tinyllama_1_1b-2x2-b1-l24"]
    assert got["local_k"] == [(2, 1, 6, 2, 16)]
    check_serve(case, want, got)


def test_an_unsplit_cache_length_stays_whole(results):
    """max_len 19 on (1, 2): the global stage's 19 slots do not split, so
    each rank holds the whole cache and decode attends it locally."""
    case, want, got = results["tinyllama_1_1b-1x2-b4-l19"]
    assert got["local_k"] == [(2, 4, 19, 2, 16)]
    check_serve(case, want, got)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "%dx%d" % m)
@pytest.mark.parametrize("arch", ["hymba_1_5b", "whisper_medium"])
def test_build_cache_gives_each_rank_its_block(arch, mesh, b):
    """``build_cache`` on the mesh: each rank's zeros have the shapes and
    dtypes of its block of the whole cache under ``cache_placement``
    (``cache_specs``), for every rank."""
    from repro_torch.launch import shardings as sh
    from repro_torch.models.transformer import ModelContext
    cfg = dataclasses.replace(get_config(arch).reduced(), **ARCHS[arch])
    whole = zoo.build_cache(cfg, b, MAX_LEN, ModelContext(), device="cpu")
    for r in range(mesh[0] * mesh[1]):
        m = worker.meshlib.Mesh(mesh, ("data", "model"), rank=r)
        want = sh.shard_tree(whole, zoo.cache_placement(cfg, b, MAX_LEN, m),
                             m)
        got = zoo.build_cache(cfg, b, MAX_LEN, ModelContext(mesh=m),
                              device="cpu")
        w, g = ckpt._leaves_with_paths(want), ckpt._leaves_with_paths(got)
        assert [(p, t.shape, t.dtype) for p, t in g] == [
            (p, t.shape, t.dtype) for p, t in w]
        assert not any(t.any() for _, t in g)
