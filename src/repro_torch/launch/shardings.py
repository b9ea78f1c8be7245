"""Sharding rules of the training mesh (the counterpart of
``repro.launch.shardings``): parameter specs by path, batch, logits and
cache specs by shape cell, and the slicing of a tree onto this rank of a
``launch.mesh.Mesh`` and back.

A spec is what ``tuple(jax.sharding.PartitionSpec(...))`` gives: one entry
a dimension, each an axis name, a tuple of axis names (the dimension split
over their product, row-major) or None (not split); a one-name tuple is
written as the name, as ``PartitionSpec`` normalises it.  The rules are the
reference's, rule by rule:

* shard a dimension only when it divides the axis size, otherwise
  replicate the tensor (Hymba's 25 heads, Gemma-3's 8 stay replicated on a
  model axis of 16 while their MLPs shard);
* ``long_500k`` (batch 1) shards the KV cache's sequence axis over every
  mesh axis instead of the batch axis;
* ``zero1=True`` also shards the optimizer's master, m and v over the data
  axes (ZeRO-1); ``fsdp=True`` the parameters too.

Every rule answers from ``mesh.shape`` and ``mesh.axis_names`` alone.  The
trainer and the serving steps of this port execute them through
``placement_specs``: the batch's data axes, the vocab rows of ``embed`` /
``out_embed``, the ``model`` entries of the attention (self and cross),
MLP and SSM leaves (the tensor-parallel shards: heads, d_ff columns and
rows, d_inner columns and SSM heads) and of the routed expert stacks (the
stored expert shards: E / mp experts a rank), and every data axis of a
train state (ZeRO-1's master, m and v; fsdp's parameters too), which
``data_leaves`` names with the dimension each splits.  A serving cache is
placed by ``cache_specs`` as it is, both axes and the sequence axis
included.  ``shard_tree`` cuts this rank's block of each leaf,
``gather_tree`` puts the whole leaf back together.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import coords_of

VOCAB_LEAVES = ("embed", "out_embed")
TP_BLOCKS = ("attn", "cross", "mlp", "ssm")
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")   # under "moe": the routed stacks


def _axsize(mesh, name) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    return math.prod(_axsize(mesh, a) for a in dp_axes(mesh))


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a one-name tuple is
    the name."""
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return e


def _spec(*entries) -> tuple:
    return tuple(_entry(e) for e in entries)


def _walk(tree, fn, path=()):
    """``fn(path names, leaf)`` over a tree of dicts, lists and tuples (the
    value tree guides the walk: a spec tree's tuples are its leaves)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _zip(tree, specs, fn, path=()):
    """``fn(path, leaf, spec)`` over ``tree`` and the spec tree of its
    structure."""
    if isinstance(tree, dict):
        return {k: _zip(v, specs[k], fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip(v, specs[i], fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, specs)


def param_spec_for(path_names, shape, cfg: ArchConfig, mp: int) -> tuple:
    """The spec of one parameter leaf, by its path and shape."""
    name = path_names[-1]

    def div(d):
        return d % mp == 0
    none = (None,) * len(shape)
    if name in VOCAB_LEAVES:
        return ("model", None)
    if name in ("final_norm",):
        return (None,)
    parent = path_names[-2] if len(path_names) >= 2 else ""
    if parent in ("attn", "cross"):
        H, K = cfg.n_heads, cfg.n_kv_heads
        if name == "wq":
            return (None, None, "model", None) if div(H) else none
        if name in ("wk", "wv"):
            return (None, None, "model", None) if div(K) else none
        if name == "wo":
            return (None, "model", None, None) if div(H) else none
    if parent == "mlp":
        if name in ("w_gate", "w_up"):
            return (None, None, "model") if div(shape[-1]) else none
        if name == "w_down":
            return (None, "model", None) if div(shape[-2]) else none
    if parent == "moe":
        E = cfg.moe.n_experts
        if name == "router":
            return none
        if name.endswith("_m"):
            return none  # mirrored experts are replicated by design
        return (None, "model", None, None) if div(E) else none
    if parent == "ssm":
        di, hd = cfg.d_inner, cfg.ssm.head_dim
        ok = div(di) and (di // mp) % hd == 0
        h_ok = ok and div(cfg.n_ssm_heads)
        if name in ("wz", "wx"):
            return (None, None, "model") if ok else none
        if name == "conv_x":
            return (None, None, "model") if ok else none
        if name == "out_proj":
            return (None, "model", None) if ok else none
        if name == "norm":
            return (None, "model") if ok else none
        if name == "wdt":
            return (None, None, "model") if h_ok else none
        if name in ("A_log", "D_skip", "dt_bias"):
            return (None, "model") if h_ok else none
        return none  # wB / wC / conv_B / conv_C (shared across heads)
    return none


def param_specs(cfg: ArchConfig, mesh, abstract_tree) -> Any:
    mp = _axsize(mesh, "model")
    return _walk(abstract_tree, lambda path, leaf: param_spec_for(
        path, tuple(leaf.shape), cfg, mp))


def _zero1_spec(spec: tuple, shape, mesh) -> tuple:
    """A param spec with data-axis sharding on its first free, divisible
    dimension (ZeRO-1's optimizer-state sharding)."""
    dsz = dp_size(mesh)
    if dsz <= 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (pp, d) in enumerate(zip(parts, shape)):
        if pp is None and d % dsz == 0:
            parts[i] = dp_axes(mesh)
            return _spec(*parts)
    return _spec(*parts)


def train_state_specs(cfg: ArchConfig, mesh, abstract_state,
                      zero1: bool = False, fsdp: bool = False
                      ) -> Dict[str, Any]:
    """Specs of ``{"params", "opt": {"master", "m", "v", "step"}}``.
    ``zero1``: the optimizer's moments and master over the data axes;
    ``fsdp``: the parameters too."""
    mp = _axsize(mesh, "model")

    def z1(path, leaf):
        return _zero1_spec(param_spec_for(path, tuple(leaf.shape), cfg, mp),
                           tuple(leaf.shape), mesh)

    params = abstract_state["params"]
    base = param_specs(cfg, mesh, params)
    zspecs = _walk(params, z1)
    ospec = zspecs if (zero1 or fsdp) else base
    return {"params": zspecs if fsdp else base,
            "opt": {"master": ospec, "m": ospec, "v": ospec, "step": ()}}


def _batch_axis(shape: ShapeConfig, mesh):
    dp = dp_axes(mesh)
    return dp if (dp and shape.global_batch % dp_size(mesh) == 0) else None


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict[str, tuple]:
    bax = _batch_axis(shape, mesh)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec(bax, None)}
        if cfg.enc_dec:
            specs["enc_embeds"] = _spec(bax, None, None)
        return specs
    return {"token": _spec(bax, None)}


def logits_spec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> tuple:
    """(B, V_pad) last-token logits: batch on the data axes, vocab on the
    model axis."""
    return _spec(_batch_axis(shape, mesh), "model")


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                abstract_cache) -> Any:
    """The spec tree of a ``model_zoo.build_cache`` tree (tensors, or on
    the ``meta`` device)."""
    B = shape.global_batch
    dp = dp_axes(mesh)
    batch_ok = dp and B % dp_size(mesh) == 0
    bax = dp if batch_ok else None
    mp = _axsize(mesh, "model")
    all_axes = tuple(mesh.axis_names)
    nall = math.prod(mesh.shape.values())

    def seq_ax(clen: int):
        if not batch_ok and clen % nall == 0:
            return all_axes   # one long sequence: over every axis
        return "model" if clen % mp == 0 else None

    def spec_for(names, leaf):
        shp = tuple(leaf.shape)
        name = names[-1]
        if name == "pos":
            return _spec(bax)
        if name == "enc_out":
            return _spec(bax, None, None)
        if name in ("k", "v"):   # (L, B, clen, K, hd)
            return _spec(None, bax, seq_ax(shp[2]), None, None)
        if name == "k_pos":      # (B, clen)
            return _spec(bax, seq_ax(shp[1]))
        if name == "state":      # (L, B, H, P, N)
            h_ok = cfg.n_ssm_heads % mp == 0
            return _spec(None, bax, "model" if h_ok else None, None, None)
        if "conv" in names:      # (L, B, w-1, C)
            di_ok = shp[-1] % mp == 0 and shp[-1] == cfg.d_inner
            return _spec(None, bax, None, "model" if di_ok else None)
        return (None,) * len(shp)

    return _walk(abstract_cache, spec_for)


def _axes(e) -> tuple:
    """The axis names of one spec entry."""
    return () if e is None else (e if isinstance(e, tuple) else (e,))


def placement_specs(specs) -> Any:
    """The spec tree as this port executes it, which is every entry the
    rules give: the data axes (the batch's leaves, and a train state's
    under ``zero1`` / ``fsdp``), and the model axis of ``embed`` /
    ``out_embed`` (their vocab rows), of the leaves under ``attn``,
    ``cross``, ``mlp`` and ``ssm`` (tensor parallelism) and of the routed
    expert stacks under ``moe`` (stored expert shards; the router and the
    mirrored experts stay whole, as ``param_spec_for`` gives them).  A
    model entry on any other leaf raises NotImplementedError: no leaf is
    quietly held whole.  Walks a tree of specs (dicts and lists of spec
    tuples)."""
    def check(names, spec):
        model = names and (names[-1] in VOCAB_LEAVES or (
            len(names) >= 2 and (names[-2] in TP_BLOCKS or (
                names[-2] == "moe" and names[-1] in EXPERT_LEAVES))))
        if not model and _has(spec, "model"):
            raise NotImplementedError(f"{'/'.join(names)}: the port does "
                                      f"not split it over the model axis "
                                      f"({spec})")
        return tuple(spec)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return check(path, tree)
    return walk(specs)


def model_leaves(specs) -> tuple:
    """(the key paths of the leaves split over the model axis, those of
    the leaves that stay whole but whose gradient each rank takes from its
    own part of the work only: a whole leaf of an ``attn``, ``cross`` or
    ``ssm`` block with a split sibling, ``wk`` / ``wv`` beside split query
    heads, the SSM's ``wB`` / ``wC`` / ``conv_B`` / ``conv_C``, and every
    whole leaf under ``moe``, the router and the mirrored experts, which
    see only the rank's token slice) under a placed spec tree; names and
    list indices as strings.  The second set's gradients must be summed
    over the model group; the stored expert stacks are in the first."""
    split, partial = set(), set()

    def walk(tree, path=()):
        if isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        elif isinstance(tree, dict):
            shared = path and (path[-1] == "moe" or (
                path[-1] in ("attn", "cross", "ssm") and any(
                    _has(spec, "model") for spec in tree.values())))
            for k, v in tree.items():
                if shared and not _has(v, "model"):
                    partial.add(path + (k,))
                walk(v, path + (k,))
        elif _has(tree, "model"):
            split.add(path)
    walk(specs)
    return split, partial


def _has(spec, axis) -> bool:
    return any(axis in _axes(e) for e in spec)


def data_leaves(specs) -> Dict[tuple, int]:
    """{key path: the dimension split over the data axes} of every leaf of
    a placed spec tree that is split over them (ZeRO-1's optimizer
    leaves, fsdp's parameters); names and list indices as strings.
    ``_zero1_spec`` puts the data axes on one dimension a leaf."""
    out = {}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            dims = [d for d, e in enumerate(tree)
                    if set(_axes(e)) & {"pod", "data"}]
            if dims:
                out[path], = dims
    walk(specs)
    return out


def local_shape(spec, shape, mesh) -> tuple:
    """The shape of the block that each mesh device holds of a leaf of
    ``shape`` under ``spec``."""
    return tuple(s.stop - s.start for s in _blocks(spec, tuple(shape), mesh,
                                                    mesh.coords))


def _blocks(spec, shape, mesh, coords):
    """The slices of the block that the mesh device at ``coords`` holds of
    a leaf of ``shape`` under ``spec``."""
    out = []
    for d, n in enumerate(shape):
        axes = _axes(spec[d] if d < len(spec) else None)
        parts, idx = 1, 0
        for a in axes:
            size = _axsize(mesh, a)
            parts, idx = parts * size, idx * size + coords.get(a, 0)
        if n % parts:
            raise ValueError(f"dimension {d} of size {n} does not split "
                             f"over {axes} ({parts} parts)")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _sharded(spec) -> bool:
    return any(e is not None for e in spec)


def shard_tree(tree, specs, mesh) -> Any:
    """This rank's block of each leaf of ``tree`` (whole tensors) under
    ``specs`` on ``mesh`` (its ``coords``): a copy of its own for a split
    leaf (a contiguous slice too, so that no block keeps the whole leaf's
    storage alive), the leaf itself for a replicated one."""
    def one(path, leaf, spec):
        if not _sharded(spec):
            return leaf
        return leaf[_blocks(spec, tuple(leaf.shape), mesh,
                            mesh.coords)].clone(
                                memory_format=torch.contiguous_format)
    return _zip(tree, specs, one)


def full_shape(spec, local_shape, mesh) -> tuple:
    """The whole leaf's shape from a block's."""
    out = []
    for d, n in enumerate(local_shape):
        axes = _axes(spec[d] if d < len(spec) else None)
        out.append(n * math.prod(_axsize(mesh, a) for a in axes))
    return tuple(out)


def assemble(parts, spec, mesh) -> torch.Tensor:
    """The whole leaf from every mesh device's block (``parts[r]`` the
    block of flat rank r)."""
    shape = full_shape(spec, tuple(parts[0].shape), mesh)
    full = parts[0].new_empty(shape)
    for r, p in enumerate(parts):
        full[_blocks(spec, shape, mesh, coords_of(mesh.shape, r))] = p
    return full


def gather_tree(tree, specs, mesh) -> Any:
    """Each leaf whole again on every rank (a replicated leaf as it is; a
    split one through an all-gather over the default group, which every
    rank calls leaf by leaf in the same order)."""
    def one(path, leaf, spec):
        if not _sharded(spec) or mesh.size == 1:
            return leaf
        leaf = leaf.contiguous()
        parts = [torch.empty_like(leaf) for _ in range(mesh.size)]
        dist.all_gather(parts, leaf)
        return assemble(parts, spec, mesh)
    return _zip(tree, specs, one)
