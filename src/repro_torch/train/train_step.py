"""Train and serve step factories (the counterpart of
``repro.train.train_step``).

``make_train_step`` builds the canonical step:

    loss -> grad (each layer recomputed under ``ModelContext.remat``) ->
    clip -> AdamW -> new state

with optional gradient accumulation over microbatches: float32
accumulators, each microbatch's gradient divided by their count and added
in microbatch order (the reference's ``lax.scan`` carry), the metrics the
mean over the microbatches.

A train state is ``{"params": tree, "opt": {"master", "m", "v", "step"}}``
in the reference's layout, its dicts keyed in sorted order.  Every leaf is
its own tensor: with tied embeddings (``gemma3_4b``) ``out_embed`` starts
as a copy of ``embed`` and from then on takes its own gradient and its own
AdamW update, as the reference's two pytree leaves do (one shared tensor
would sum the two gradients).  ``abstract_train_state`` gives the tree
on the ``meta`` device, for the sharding rules.

On the training mesh (``ModelContext.mesh``) each rank holds its state
as ``launch.shardings.placement_specs`` places it: the vocab rows of
``embed`` / ``out_embed``, its heads of the attention leaves (``wk`` /
``wv`` whole where the kv heads do not split), its d_ff columns and rows
of the MLP, its d_inner columns and SSM heads (``wB`` / ``wC`` /
``conv_B`` / ``conv_C`` whole), and every other leaf whole; the
optimizer's master, m and v the same blocks.  It takes the global batch
and runs microbatch i's rows of its data slice, as the reference's
sharded batch splits under microbatches (which decides the MoE layers'
capacity).  Its gradients are its slice's part of the global loss's:
those of the leaves used only in the token-split MoE region (router,
experts, mirrored experts) and of the whole leaves of a split block
(each rank's cotangent covers its own heads) are summed over the model
group, then every one over the data group, which gives each rank the
reference's gradient of its leaves (its shard of a split leaf).  The
grad norm counts each split leaf's shards once, and AdamW runs on each
rank's leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import shardings as sh
from repro_torch.models import embedding as emb
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import ModelContext
from repro_torch.train.optimizer import (OptConfig, abstract_opt_state,
                                         adamw_update, init_opt_state,
                                         tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    opt: OptConfig = OptConfig()
    aux_weight: float = 0.01


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     device="cuda", dtype: torch.dtype = torch.float32,
                     model_parallel: int = 1) -> Dict[str, Any]:
    """Fresh params (``model_zoo.init_params``'s recipe, drawn from
    ``generator``) and their optimizer state; a tied ``out_embed`` becomes
    a leaf of its own."""
    params = zoo.init_params(cfg, generator, device, dtype, model_parallel)
    if cfg.tie_embeddings:
        params["out_embed"] = params["embed"].clone()
    return {"params": params, "opt": init_opt_state(params)}


def abstract_train_state(cfg: ArchConfig, model_parallel: int = 1,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> Dict[str, Any]:
    """The train state's tree on the ``meta`` device (the reference's
    ``abstract_train_state``)."""
    params = zoo.abstract_params(cfg, model_parallel, dtype)
    return {"params": params, "opt": abstract_opt_state(params)}


def _grads(cfg: ArchConfig, ctx: ModelContext, step_cfg: StepConfig,
           params, batch):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: grads a tree of
    params' structure (zeros for a leaf the loss does not reach, e.g. the
    mirrored experts' weights of a model that mirrors none, as JAX gives)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = zoo.loss_fn(p, cfg, ctx, batch,
                                aux_weight=step_cfg.aux_weight)
    leaves = tree_leaves(p)
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def take(t):
        g = next(got)
        return torch.zeros_like(t) if g is None else g
    grads = tree_map(take, p)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _paths(tree, path=()):
    """The key path of each leaf, in the walk's order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    return [path]


def _all_reduce(ts, group) -> None:
    """Sum each tensor of ``ts`` over ``group`` in place, in one flat
    buffer a dtype."""
    for dt in {t.dtype for t in ts}:
        part = [t for t in ts if t.dtype == dt]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, group=group)
        for t, v in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(v.view_as(t))


def _mesh_paths(cfg: ArchConfig, mesh):
    """``shardings.model_leaves`` of the placed param specs."""
    return sh.model_leaves(sh.placement_specs(sh.param_specs(
        cfg, mesh, zoo.abstract_params(cfg, mesh.model_size))))


def _key(path) -> tuple:
    return tuple(str(k) for k in path)


def _mesh_reduce(mesh, grads, partial) -> None:
    """Complete each rank's gradients in place: over the model group those
    of the MoE leaves (each rank routed its own tokens) and of the whole
    leaves of a tensor-parallel block (``partial``: each rank's cotangent
    covers its own heads), then every leaf's over the data group (each
    rank ran its own rows)."""
    leaves = tree_leaves(grads)
    paths = _paths(grads)
    if mesh.model_size > 1:
        own = [g for g, p in zip(leaves, paths)
               if "moe" in p or _key(p) in partial]
        if own:
            _all_reduce(own, mesh.model_group)
    if mesh.data_size > 1:
        _all_reduce(leaves, mesh.data_group)


def _split_squares(mesh, grads, split):
    """``global_norm``'s hook on the mesh: the sum of squares of each leaf
    split over the model group (the vocab rows, the tensor-parallel
    shards) summed over the group, so each element counts once."""
    idx = [i for i, p in enumerate(_paths(grads)) if _key(p) in split]

    def fn(sq):
        if mesh.model_size == 1 or not idx:
            return sq
        both = torch.stack([sq[i] for i in idx])
        dist.all_reduce(both, group=mesh.model_group)
        sq = list(sq)
        for j, i in enumerate(idx):
            sq[i] = both[j]
        return sq
    return fn


def make_train_step(cfg: ArchConfig, ctx: ModelContext,
                    step_cfg: StepConfig = StepConfig()):
    """``train_step(state, batch) -> (new_state, metrics)``; ``batch``
    holds tensors on the params' device ({"tokens": (B, S) int,
    "enc_embeds": ...}), the global batch on the mesh; metrics: loss, nll,
    aux, grad_norm, lr (0-d tensors).  The step is ``train_step.update(
    state, train_step.grads(params, batch))``: ``grads`` gives (loss,
    metrics, gradients) complete on each rank, ``update`` the clip and
    AdamW."""
    mesh = ctx.mesh
    n = step_cfg.n_microbatches
    if mesh is not None:
        split, partial = _mesh_paths(cfg, mesh)

    def rows(batch, i):
        """Microbatch i of the global batch, then this rank's data slice."""
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} "
                             "microbatches")
        b = B // n
        lo, hi = i * b, (i + 1) * b
        if mesh is not None:
            emb.check_shardable(b, cfg.padded_vocab(mesh.model_size), mesh)
            b //= mesh.data_size
            lo += mesh.data_rank * b
            hi = lo + b
        return {k: v[lo:hi] for k, v in batch.items()}

    def single(params, batch):
        return _grads(cfg, ctx, step_cfg, params, batch)

    def accumulated(params, batch):
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        losses, metrics = [], []
        for i in range(n):
            loss, m, grads = single(params, rows(batch, i))
            acc = tree_map(lambda a, g: a + g.to(torch.float32) / n, acc,
                           grads)
            losses.append(loss)
            metrics.append(m)
        mean = {k: torch.stack([m[k] for m in metrics]).mean()
                for k in metrics[0]}
        return torch.stack(losses).mean(), mean, acc

    def grads(params, batch):
        if n == 1:
            loss, metrics, g = single(params, rows(batch, 0))
        else:
            loss, metrics, g = accumulated(params, batch)
        if mesh is not None:
            _mesh_reduce(mesh, g, partial)
        return loss, metrics, g

    def update(state, got):
        loss, metrics, g = got
        new_params, new_opt, opt_metrics = adamw_update(
            state["params"], g, state["opt"], step_cfg.opt,
            None if mesh is None else _split_squares(mesh, g, split))
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    def train_step(state, batch):
        return update(state, grads(state["params"], batch))

    train_step.grads, train_step.update = grads, update
    return train_step


def make_prefill_step(cfg: ArchConfig, ctx: ModelContext, max_len: int = 0):
    def prefill_step(params, batch):
        return zoo.prefill(params, cfg, ctx, batch["tokens"],
                           enc_embeds=batch.get("enc_embeds"),
                           max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx: ModelContext, max_len: int = 0):
    """On the mesh ``max_len`` is the context the cache was placed for
    (``make_prefill_step``'s)."""
    def serve_step(params, token, cache):
        return zoo.decode_step(params, cfg, ctx, token, cache,
                               max_len=max_len)
    return serve_step
