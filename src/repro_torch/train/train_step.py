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
as the placed state specs say (``make_train_step``'s ``specs``, by
default ``launch.shardings.placement_specs`` of ``train_state_specs``):
the vocab rows of ``embed`` / ``out_embed``, its heads of the attention
leaves (``wk`` / ``wv`` whole where the kv heads do not split), its d_ff
columns and rows of the MLP, its d_inner columns and SSM heads (``wB`` /
``wC`` / ``conv_B`` / ``conv_C`` whole), its E / mp routed experts, and
every other leaf whole; under ``zero1`` its block of the optimizer's
master, m and v over the data axes too, under ``fsdp`` also of the
parameters (the model gathers those where it uses them,
``collectives.DataBlock``).  It takes the global batch and runs
microbatch i's rows of its data slice, as the reference's sharded batch
splits under microbatches (which decides the MoE layers' capacity).  Its
gradients are its slice's part of the global loss's.  Those of the
leaves used only for the rank's own part of the work (the router and the
mirrored experts, which see its token slice; the whole leaves of a split
block, whose cotangent covers its own heads) are summed over the model
group; then over the data group each leaf's is all-reduced where its
optimizer state is whole, reduce-scattered to the rank's block where
ZeRO-1 splits it, and left as it is under fsdp, where the gather's
backward has summed it already.  That gives each rank the reference's
gradient of its block of each leaf, once each microbatch's float32 sum is
complete.  The grad norm counts each element once over both groups,
AdamW runs on each rank's blocks of master, m and v, and under ZeRO-1 the
new parameters (the master blocks, cast) are all-gathered over the data
group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import shardings as sh
from repro_torch.models import collectives as coll
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
           params, batch, view=None):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: grads a tree of
    params' structure (zeros for a leaf the loss does not reach, e.g. the
    mirrored experts' weights of a model that mirrors none, as JAX gives).
    ``view`` maps the differentiable leaves' tree to the one the model
    reads (fsdp's ``DataBlock``s)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = zoo.loss_fn(p if view is None else view(p), cfg, ctx,
                                batch, aux_weight=step_cfg.aux_weight)
    leaves = tree_leaves(p)
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def take(t):
        g = next(got)
        return torch.zeros_like(t) if g is None else g
    grads = tree_map(take, p)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _map_paths(fn, tree, path=()):
    """``fn(key path, leaf)`` over a tree (names and list indices as
    strings, ``launch.shardings``' key paths); the result has its
    structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _keys(tree) -> list:
    """The key path of each leaf, in the walk's order."""
    out = []
    _map_paths(lambda path, _: out.append(path), tree)
    return out


def _all_reduce(ts, group) -> None:
    """Sum each tensor of ``ts`` over ``group`` in place, in one flat
    buffer a dtype (the dtypes in the order they first appear, the same
    on every rank: a set's order may differ between processes)."""
    for dt in dict.fromkeys(t.dtype for t in ts):
        part = [t for t in ts if t.dtype == dt]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, group=group)
        for t, v in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(v.view_as(t))


def _rows(t, dim: int, n: int):
    """``t`` as (n, -1): row r its r-th block along ``dim``."""
    return t.movedim(dim, 0).reshape(n, -1)


def _unrows(flat, dim: int, like_shape, n: int):
    """The inverse of ``_rows`` for ``n`` blocks of ``like_shape`` (the
    result's ``dim`` is ``n`` times ``like_shape``'s), in a contiguous
    tensor of its own: ``flat`` is a part of a collective's buffer, which
    a view would keep alive."""
    moved = list(like_shape)
    moved.insert(0, moved.pop(dim))
    moved[0] *= n
    out = flat.new_empty(moved)
    out.view(flat.shape).copy_(flat)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(leaves, dims, group, n):
    """Each leaf summed over ``group`` and cut to this rank's block along
    its dimension in ``dims``: one reduce-scatter of a flat buffer a
    dtype.  Returns the blocks."""
    out = [None] * len(leaves)
    for dt in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dt]
        buf = torch.cat([_rows(leaves[i], dims[i], n) for i in idx], dim=1)
        mine = coll.reduce_scatter(buf, group, 0)[0]
        for i, v in zip(idx, mine.split(
                [leaves[i].numel() // n for i in idx])):
            shape = list(leaves[i].shape)
            shape[dims[i]] //= n
            out[i] = _unrows(v, dims[i], shape, 1)
    return out


def _all_gather(blocks, dims, group, n):
    """Each block made whole along its dimension in ``dims`` over
    ``group``: one all-gather of a flat buffer a dtype."""
    out = [None] * len(blocks)
    for dt in dict.fromkeys(t.dtype for t in blocks):
        idx = [i for i, t in enumerate(blocks) if t.dtype == dt]
        buf = torch.cat([blocks[i].movedim(dims[i], 0).reshape(1, -1)
                         for i in idx], dim=1)
        every = coll.all_gather(buf, group, 0)
        for i, v in zip(idx, every.split(
                [blocks[i].numel() for i in idx], dim=1)):
            out[i] = _unrows(v, dims[i], blocks[i].shape, n)
    return out


@dataclasses.dataclass(frozen=True)
class _Placement:
    """What the step does with each leaf on the mesh, from the placed
    state specs: ``split`` (split over the model axis), ``partial``
    (whole, its gradient summed over the model group), ``fsdp`` and
    ``zero1`` ({key path: the dimension split over the data axes} of the
    parameters, and of the optimizer state where the parameters stay
    whole)."""
    split: frozenset
    partial: frozenset
    fsdp: Dict[tuple, int]
    zero1: Dict[tuple, int]

    @classmethod
    def of(cls, specs) -> "_Placement":
        split, partial = sh.model_leaves(specs["params"])
        fsdp = sh.data_leaves(specs["params"])
        opt = sh.data_leaves(specs["opt"]["master"])
        if any(opt.get(k) != d for k, d in fsdp.items()):
            raise ValueError("fsdp's parameter blocks must be the "
                             "optimizer state's")
        return cls(frozenset(split), frozenset(partial), fsdp,
                   {k: d for k, d in opt.items() if k not in fsdp})


def _mesh_reduce(mesh, grads, place: _Placement):
    """Each rank's gradients completed: over the model group those of
    ``place.partial``, then over the data group every leaf's but fsdp's
    (all-reduced where the optimizer state is whole, reduce-scattered to
    this rank's block under ZeRO-1).  Returns the tree."""
    leaves, keys = tree_leaves(grads), _keys(grads)
    if mesh.model_size > 1:
        own = [g for g, k in zip(leaves, keys) if k in place.partial]
        if own:
            _all_reduce(own, mesh.model_group)
    if mesh.data_size > 1:
        _all_reduce([g for g, k in zip(leaves, keys)
                     if k not in place.fsdp and k not in place.zero1],
                    mesh.data_group)
        z = [i for i, k in enumerate(keys) if k in place.zero1]
        if z:
            blocks = _reduce_scatter([leaves[i] for i in z],
                                     [place.zero1[keys[i]] for i in z],
                                     mesh.data_group, mesh.data_size)
            for i, b in zip(z, blocks):
                leaves[i] = b
    it = iter(leaves)
    return tree_map(lambda _: next(it), grads)


def _split_squares(mesh, grads, place: _Placement):
    """``global_norm``'s hook on the mesh: the sum of squares of each leaf
    split over the model axis (the vocab rows, the tensor-parallel shards,
    the stored experts) summed over the model group, and of each leaf
    whose gradient is a block over the data axes (ZeRO-1, fsdp) over the
    data group, so each element counts once."""
    keys = _keys(grads)
    groups = ((mesh.model_group, mesh.model_size, place.split),
              (mesh.data_group, mesh.data_size,
               set(place.fsdp) | set(place.zero1)))

    def fn(sq):
        sq = list(sq)
        for group, size, paths in groups:
            idx = [i for i, k in enumerate(keys) if k in paths]
            if size == 1 or not idx:
                continue
            both = torch.stack([sq[i] for i in idx])
            dist.all_reduce(both, group=group)
            for j, i in enumerate(idx):
                sq[i] = both[j]
        return sq
    return fn


def make_train_step(cfg: ArchConfig, ctx: ModelContext,
                    step_cfg: StepConfig = StepConfig(), specs=None):
    """``train_step(state, batch) -> (new_state, metrics)``; ``batch``
    holds tensors on the params' device ({"tokens": (B, S) int,
    "enc_embeds": ...}), the global batch on the mesh; metrics: loss, nll,
    aux, grad_norm, lr (0-d tensors).  ``specs``: on the mesh, the placed
    spec tree of the state (``placement_specs`` of ``train_state_specs``
    with its ``zero1`` / ``fsdp``; without either if None), by which the
    state is laid out.  The step is ``train_step.update(state,
    train_step.grads(params, batch))``: ``grads`` gives (loss, metrics,
    gradients) complete on each rank (its blocks), ``update`` the clip
    and AdamW."""
    mesh = ctx.mesh
    n = step_cfg.n_microbatches
    view = place = None
    if mesh is not None:
        if specs is None:
            specs = sh.placement_specs(sh.train_state_specs(
                cfg, mesh, abstract_train_state(cfg, mesh.model_size)))
        place = _Placement.of(specs)
        if place.fsdp and mesh.data_size > 1:
            def view(p):
                return _map_paths(lambda k, t: coll.DataBlock(
                    t, mesh.data_group, place.fsdp[k])
                    if k in place.fsdp else t, p)

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
        return _grads(cfg, ctx, step_cfg, params, batch, view)

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
            g = _mesh_reduce(mesh, g, place)
        return loss, metrics, g

    def update(state, got):
        loss, metrics, g = got
        new_params, new_opt, opt_metrics = adamw_update(
            state["params"], g, state["opt"], step_cfg.opt,
            None if mesh is None else _split_squares(mesh, g, place))
        if mesh is not None and place.zero1 and mesh.data_size > 1:
            new_params = _gather_zero1(mesh, new_params, place)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    def train_step(state, batch):
        return update(state, grads(state["params"], batch))

    train_step.grads, train_step.update = grads, update
    return train_step


def _gather_zero1(mesh, params, place: _Placement):
    """The new parameters of ZeRO-1's leaves (this rank's master blocks,
    cast) made whole over the data group."""
    leaves, keys = tree_leaves(params), _keys(params)
    z = [i for i, k in enumerate(keys) if k in place.zero1]
    whole = _all_gather([leaves[i] for i in z],
                        [place.zero1[keys[i]] for i in z], mesh.data_group,
                        mesh.data_size)
    for i, w in zip(z, whole):
        leaves[i] = w
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


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
