"""The ranks of the tensor-parallel tests (``tests/test_torch_serve_mesh*.py``,
``tests/test_torch_tp_grad.py``): spawned processes that run rounds, each
a gloo group of its own world size (the ranks past it sit the round out),
and write what they computed.  This module imports neither JAX nor the
JAX package.

The spec (a pickle the test writes) holds ``rounds``: a list of (world
size, [case, ...]); each case is a dict with a ``kind`` (``serve``,
``grad``, ``combine``, ``ckpt``), its mesh and its inputs as numpy arrays.
Rank r writes ``{case name: result}`` to ``<out>.<r>``.
"""
import dataclasses
import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import shardings as sh
from repro_torch.models import layers
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as tts

WORLD = 4
GROUP_TIMEOUT_S = 120


def _np(t):
    return t.detach().cpu().numpy()


def reduced(get_config, arch: str, over: dict):
    """``arch``'s reduced config with ``over``'s fields replaced (its
    ``ssm`` entry a dict of SSMConfig fields)."""
    over = dict(over)
    ssm = over.pop("ssm", None)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return cfg if ssm is None else dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))


def _cfg(case):
    return reduced(get_config, case["arch"], case["over"])


def _tree(like, flat: dict):
    """``like``'s structure with ``flat``'s leaves (keystr -> numpy)."""
    paths = [p for p, _ in ckpt._leaves_with_paths(like)]
    if set(paths) != set(flat):
        raise ValueError(f"leaves differ: {set(paths) ^ set(flat)}")
    return ckpt._unflatten(like, iter(
        [torch.from_numpy(np.array(flat[p])) for p in paths]))


def _param_specs(cfg, mesh):
    return sh.placement_specs(sh.param_specs(
        cfg, mesh, zoo.abstract_params(cfg, mesh.model_size)))


def _gather_logits(logits, cfg, B, mesh):
    """The whole (B, V_pad) logits from every rank's block of
    ``logits_spec``."""
    spec = sh.logits_spec(cfg, ShapeConfig("serve", 1, B, "decode"), mesh)
    return _np(sh.gather_tree({"x": logits}, {"x": spec}, mesh)["x"])


# ---------------------------------------------------------------------------
# prefill and decode_step on the mesh
# ---------------------------------------------------------------------------

def serve_case(case: dict) -> dict:
    """Prefill the case's prompts, then one decode step for each of its
    tokens, on the mesh with the params placed by ``placement_specs``;
    the logits after each call and the cache after the last, whole."""
    mesh = meshlib.make_mesh(case["mesh"], ("data", "model"))
    cfg = _cfg(case)
    like = zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = sh.shard_tree(_tree(like, case["params"]),
                           _param_specs(cfg, mesh), mesh)
    ctx = tf.ModelContext(q_chunk=64, kernels=case["kernels"], mesh=mesh)
    tokens = torch.from_numpy(case["tokens"])
    B, max_len = tokens.shape[0], case["max_len"]
    enc = case.get("enc_embeds")
    logits = []
    with torch.no_grad():
        lg, cache = zoo.prefill(
            params, cfg, ctx, tokens, max_len=max_len,
            enc_embeds=None if enc is None else torch.from_numpy(enc))
        logits.append(_gather_logits(lg, cfg, B, mesh))
        for tok in case["steps"]:
            lg, cache = zoo.decode_step(params, cfg, ctx,
                                        torch.from_numpy(tok), cache,
                                        max_len=max_len)
            logits.append(_gather_logits(lg, cfg, B, mesh))
    whole = sh.gather_tree(cache, zoo.cache_placement(cfg, B, max_len, mesh),
                           mesh)
    return {"logits": logits,
            "cache": {p: _np(t) for p, t in ckpt._leaves_with_paths(whole)},
            "local_k": [tuple(s["k"].shape) for s in cache["stages"]
                        if "k" in s]}


# ---------------------------------------------------------------------------
# the train step's gradients under tensor parallelism
# ---------------------------------------------------------------------------

def grad_case(case: dict) -> dict:
    """``make_train_step(...).grads`` on the mesh: the loss and this
    rank's gradient of each leaf (its shard of a split leaf), complete
    after the model- and data-group sums."""
    mesh = meshlib.make_mesh(case["mesh"], ("data", "model"))
    cfg = _cfg(case)
    like = tts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                "cpu")["params"]
    params = sh.shard_tree(_tree(like, case["params"]),
                           _param_specs(cfg, mesh), mesh)
    step = tts.make_train_step(cfg, tf.ModelContext(
        q_chunk=64, kernels=case["kernels"], remat=case["remat"], mesh=mesh))
    loss, _, grads = step.grads(params, {k: torch.from_numpy(v)
                                         for k, v in case["batch"].items()})
    return {"loss": float(loss),
            "grads": {p: _np(t) for p, t in ckpt._leaves_with_paths(grads)}}


# ---------------------------------------------------------------------------
# the decode combine alone
# ---------------------------------------------------------------------------

def combine_case(case: dict) -> dict:
    """``layers.decode_attention_split`` on this rank's block of slots,
    the sequence axis split over the default group."""
    n, r = dist.get_world_size(), dist.get_rank()
    out = {}
    for name, (q, k, v, valid) in case["inputs"].items():
        c = k.shape[1] // n
        sl = slice(r * c, (r + 1) * c)
        o = layers.decode_attention_split(
            torch.from_numpy(q), torch.from_numpy(k[:, sl]).contiguous(),
            torch.from_numpy(v[:, sl]).contiguous(),
            torch.from_numpy(valid[:, sl]).contiguous(),
            case["scale"], dist.group.WORLD)
        out[name] = _np(o)
    return out


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

def ckpt_case(case: dict) -> dict:
    """The case's train state placed on the mesh (``placement_specs``):
    saved through ``save_gathered`` to ``case["save"]``, and each of
    ``case["restore"]`` restored, ``resharded`` onto the mesh and
    gathered again (keystr -> numpy of the whole leaves)."""
    mesh = meshlib.make_mesh(case["mesh"], ("data", "model"))
    cfg = _cfg(case)
    like = tts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    specs = sh.placement_specs(sh.train_state_specs(
        cfg, mesh, tts.abstract_train_state(cfg, mesh.model_size,
                                            torch.float32)))
    state = ckpt.resharded(_tree(like, case["state"]), mesh, specs)
    if case.get("save"):
        ckpt.save_gathered(case["save"], 1, state, specs, mesh)
    out = {"local_wq": tuple(state["params"]["stages"][0]["layers"]["attn"]
                             ["wq"].shape)}
    for d in case["restore"]:
        restored, _ = ckpt.restore(d, like)
        placed = ckpt.resharded(restored, mesh, specs)
        whole = sh.gather_tree(placed, specs, mesh)
        out[d] = {p: _np(t) for p, t in ckpt._leaves_with_paths(whole)}
    return out


KINDS = {"serve": serve_case, "grad": grad_case, "combine": combine_case,
         "ckpt": ckpt_case}


def rank_main(rank: int, store_dir: str, spec_path: str,
              out_path: str) -> None:
    """Run every round of the spec that holds this rank."""
    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        rounds = pickle.load(f)["rounds"]
    out = {}
    for i, (world, cases) in enumerate(rounds):
        if rank >= world:
            continue
        dist.init_process_group(
            "gloo", init_method=f"file://{store_dir}/store_{i}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            for case in cases:
                out[case["name"]] = KINDS[case["kind"]](case)
        finally:
            meshlib.destroy()
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(out, f)
