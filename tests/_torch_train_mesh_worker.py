"""The ranks of the training-mesh tests (``tests/test_torch_embed_sharded.py``,
``tests/test_torch_moe_ep_grad.py``, ``tests/test_torch_train_mesh*.py``):
spawned processes that run rounds, each a gloo group of its own world
size (the ranks past it sit the round out), and write what they
computed.  This module imports neither JAX nor the JAX package.

The spec (a pickle the test writes) holds ``rounds``: a list of (world
size, [case, ...]); each case is a dict with a ``kind`` (``embed``,
``moe``, ``train``), its mesh and its inputs as numpy arrays.  Rank r
writes ``{case name: result}`` to ``<out>.<r>``.
"""
import dataclasses
import datetime
import pickle
import types

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import MoEConfig, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import shardings as sh
from repro_torch.models import embedding as emb
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

WORLD = 4
GROUP_TIMEOUT_S = 120


def _np(t):
    return t.detach().cpu().numpy()


def _gather_rows(t, group):
    """Every rank's rows of ``t`` (equal shapes) concatenated in the
    group's rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# embed_lookup_sharded and the vocab-sharded loss
# ---------------------------------------------------------------------------

def embed_case(case: dict) -> dict:
    """The lookup's output (gathered), its table gradient (this rank's
    rows, summed over the data group, gathered over the model group), U
    of this worker; the vocab-sharded loss and its gradients."""
    mesh = meshlib.make_mesh(case["mesh"], ("data", "model"))
    table = torch.from_numpy(case["table"])
    ids = torch.from_numpy(case["ids"])
    cot = torch.from_numpy(case["cot"])
    V, D = table.shape
    B = ids.shape[0]
    emb.check_shardable(B, V, mesh)
    b, v = B // mesh.data_size, V // mesh.model_size
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    vrows = slice(mesh.model_rank * v, (mesh.model_rank + 1) * v)
    t_loc = table[vrows].clone().requires_grad_(True)
    emb.record = []
    try:
        out = emb.embed_lookup_sharded(t_loc, ids[rows], mesh)
        rec, = emb.record
    finally:
        emb.record = None
    (g,) = torch.autograd.grad((out * cot[rows]).sum(), [t_loc])
    if mesh.data_size > 1:
        dist.all_reduce(g, group=mesh.data_group)
    res = {"out": _np(_gather_rows(out, mesh.data_group)),
           "grad": _np(_gather_rows(g, mesh.model_group)),
           "unique": int(rec["unique"]), "tokens": rec["tokens"],
           "stats": tdata.token_stats(case["ids"][rows])}
    # the loss: logits of this rank's columns, the global masked mean
    h = torch.from_numpy(case["h"])[rows].clone().requires_grad_(True)
    o_loc = table[vrows].clone().requires_grad_(True)
    labels = torch.from_numpy(case["labels"])[rows]
    mask = torch.from_numpy(case["mask"])[rows]
    loss = emb.softmax_xent(emb.logits_matmul(h, o_loc, mesh), labels, mask,
                            mesh)
    gh, go = torch.autograd.grad(loss, [h, o_loc])
    if mesh.data_size > 1:
        dist.all_reduce(go, group=mesh.data_group)
    res.update(loss=float(loss), grad_h=_np(_gather_rows(gh, mesh.data_group)),
               grad_table=_np(_gather_rows(go, mesh.model_group)))
    return res


# ---------------------------------------------------------------------------
# moe_ffn_ep and _moe_call under autograd
# ---------------------------------------------------------------------------

MOE_LEAVES = ("router", "w_gate", "w_up", "w_down", "w_gate_m", "w_up_m",
              "w_down_m")


def moe_case(case: dict) -> dict:
    """Gradients of sum(y * cot) + aux_weight * aux through moe_ffn_ep on
    this rank's slice (x's slice; the weights summed over the ranks) and
    through ``_moe_call`` on the replicated tokens (x whole; the weights
    summed)."""
    dp, ep = case["mesh"]
    mcfg = MoEConfig(**case["cfg"])
    x = torch.from_numpy(case["x"])
    cot = torch.from_numpy(case["cot"])
    aux_w = case["aux_weight"]
    ctx = moe.ep_context(dp, ep)
    r, n = dist.get_rank(), dist.get_world_size()
    T_loc = x.shape[0] // n
    out = {}
    for form in ("ep", "call"):
        w = {k: torch.from_numpy(case[k]).clone().requires_grad_(True)
             for k in MOE_LEAVES}
        if form == "ep":
            xs = x[r * T_loc:(r + 1) * T_loc].clone().requires_grad_(True)
            y, aux = moe.moe_ffn_ep(xs, w, mcfg, ctx)
            loss = (y * cot[r * T_loc:(r + 1) * T_loc]).sum() + aux_w * aux
        else:
            xs = x.clone().requires_grad_(True)
            y, aux = tf._moe_call(xs, w, types.SimpleNamespace(moe=mcfg),
                                  tf.ModelContext(moe=ctx))
            loss = (y * cot).sum() + aux_w * aux
        grads = torch.autograd.grad(loss, [xs] + [w[k] for k in MOE_LEAVES],
                                    allow_unused=True)
        gx = grads[0]
        gw = [torch.zeros_like(w[k]) if g is None else g
              for k, g in zip(MOE_LEAVES, grads[1:])]
        for g in gw:
            dist.all_reduce(g)
        if form == "ep":
            gx = _gather_rows(gx, dist.group.WORLD)
        out[form] = {"x": _np(gx), "y": _np(y), "aux": float(aux),
                     **{k: _np(g) for k, g in zip(MOE_LEAVES, gw)}}
    return out


# ---------------------------------------------------------------------------
# make_train_step on the mesh
# ---------------------------------------------------------------------------

def _state(cfg, flat: dict) -> dict:
    """The train state whose leaves are ``flat``'s (keystr -> numpy)."""
    like = tts.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    paths = [p for p, _ in ckpt._leaves_with_paths(like)]
    if set(paths) != set(flat):
        raise ValueError(f"state leaves differ: {set(paths) ^ set(flat)}")
    leaves = iter([torch.from_numpy(np.array(flat[p])) for p in paths])
    return ckpt._unflatten(like, leaves)


def train_case(case: dict) -> dict:
    """A step of make_train_step on the mesh for each of the case's global
    batches, from the case's state placed by ``train_state_specs`` with
    the case's ``zero1`` / ``fsdp``; the result holds the metrics of each
    step, the gathered state (keystr -> numpy) and this rank's shape of
    every leaf, which it first holds to ``local_shape`` of its spec after
    the last step (raising otherwise).  With ``case["ckpt"]`` the state is also saved there
    through ``save_gathered``; with ``case["cut"]`` = k the state after k
    steps is saved to ``case["cut_dir"]``, restored whole and placed again
    through ``resharded`` before the next step (a resumed run)."""
    mesh = meshlib.make_mesh(case["mesh"], ("data", "model"))
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              **case["over"])
    full = _state(cfg, case["state"])
    abstract = tts.abstract_train_state(cfg, mesh.model_size, torch.float32)
    specs = sh.placement_specs(sh.train_state_specs(
        cfg, mesh, abstract, zero1=case.get("zero1", False),
        fsdp=case.get("fsdp", False)))
    state = ckpt.resharded(full, mesh, specs)
    want = {}
    sh._zip(abstract, specs, lambda path, leaf, spec: want.setdefault(
        path, sh.local_shape(spec, leaf.shape, mesh)))
    opt = topt.OptConfig(**case["opt"])
    step = tts.make_train_step(
        cfg, tf.ModelContext(q_chunk=64, remat=case["remat"], mesh=mesh),
        tts.StepConfig(n_microbatches=case["micro"], opt=opt), specs)
    metrics = []
    for k, b in enumerate(case["batches"]):
        if k and k == case.get("cut"):
            ckpt.save_gathered(case["cut_dir"], k, state, specs, mesh)
            restored, _ = ckpt.restore(case["cut_dir"], full)
            state = ckpt.resharded(restored, mesh, specs)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    got = {}
    sh._walk(state, lambda path, t: got.setdefault(path, tuple(t.shape)))
    bad = [(p, got.get(p), w) for p, w in want.items() if got.get(p) != w]
    if bad or set(got) != set(want):   # each rank holds its blocks only
        raise AssertionError(f"rank {mesh.rank}: shapes that are not "
                             f"local_shape of their spec: {bad[:4]}")
    local = {p: tuple(t.shape) for p, t in ckpt._leaves_with_paths(state)}
    whole = sh.gather_tree(state, specs, mesh)
    if case.get("ckpt"):
        ckpt.save_gathered(case["ckpt"], len(case["batches"]), state, specs,
                           mesh)
    return {"metrics": metrics,
            "state": {p: _np(t) for p, t in ckpt._leaves_with_paths(whole)},
            "local_shapes": local,
            "local_vocab_rows": tuple(state["params"]["embed"].shape)}


KINDS = {"embed": embed_case, "moe": moe_case, "train": train_case}


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
