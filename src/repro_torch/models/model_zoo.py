"""ArchConfig -> runnable model: parameter shapes and initialisation (real
or abstract, on the ``meta`` device), the weights carried across from the
JAX package, the full forward and the training loss (``loss_fn``), on one
device or on the training mesh (``ModelContext.mesh``), and the serving
entry points (cache build, prefill, decode), on one device or on the mesh
(the cache placed as ``launch.shardings.cache_specs`` places it) --
the port of ``repro.models.model_zoo`` for every stage kind: ``dense``,
``ssm``, ``hybrid``, ``moe``, and the encoder-decoder's ``enc`` and
``dec_cross``.

Parameters are a nested dict of tensors in the JAX package's layout, every
per-stage weight stacked on a leading layer axis:

    params = {
      'embed':      (V_pad, D),
      'out_embed':  (V_pad, D),            # is 'embed' when tie_embeddings
      'final_norm': (D,),
      'stages':     [ {'layers': {...stacked...}}, ... ],
      'enc':        {'stages': [...], 'final_norm': (D,)}   # enc_dec only
    }

so the reference's parameter tree maps one to one
(``params_from_reference``).  An encoder-decoder model (Whisper) takes
``enc_embeds``, the (B, enc_seq, d_model) frame embeddings of the
reference's stub audio front end, through ``forward_logits`` and
``prefill``; the encoder runs once, and its output rides in the cache
(``enc_out``) for every decode step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import shardings as sh
from repro_torch.models import collectives as coll
from repro_torch.models import embedding as emb
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import (ModelContext, StageSpec,
                                            apply_stage_decode,
                                            apply_stage_seq, build_stages,
                                            check_supported, enc_stage,
                                            stage_kpos)

NEG_INF_F32 = -2.0 ** 30


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ArchConfig, L: int) -> Dict[str, tuple]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": (L, D, H, hd), "wk": (L, D, K, hd),
            "wv": (L, D, K, hd), "wo": (L, H, hd, D)}


def _ssm_shapes(cfg: ArchConfig, L: int) -> Dict[str, tuple]:
    D = cfg.d_model
    di = cfg.d_inner
    g, n = cfg.ssm.n_groups, cfg.ssm.d_state
    h = cfg.n_ssm_heads
    w = cfg.ssm.conv_width
    return {"wz": (L, D, di), "wx": (L, D, di), "wB": (L, D, g * n),
            "wC": (L, D, g * n), "wdt": (L, D, h),
            "conv_x": (L, w, di), "conv_B": (L, w, g * n),
            "conv_C": (L, w, g * n),
            "A_log": (L, h), "D_skip": (L, h), "dt_bias": (L, h),
            "norm": (L, di), "out_proj": (L, di, D)}


def _mlp_shapes(cfg: ArchConfig, L: int) -> Dict[str, tuple]:
    D, F = cfg.d_model, cfg.d_ff
    return {"w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)}


def _moe_shapes(cfg: ArchConfig, L: int) -> Dict[str, tuple]:
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    m = max(cfg.moe.n_mirrored_experts, 1)  # the reference keeps a leaf
    return {"router": (L, D, E),
            "w_gate": (L, E, D, F), "w_up": (L, E, D, F),
            "w_down": (L, E, F, D),
            "w_gate_m": (L, m, D, F), "w_up_m": (L, m, D, F),
            "w_down_m": (L, m, F, D)}


def stage_param_shapes(cfg: ArchConfig, stage: StageSpec) -> Dict[str, Any]:
    L, D = stage.n_layers, cfg.d_model
    out: Dict[str, Any] = {"norm1": (L, D)}
    if stage.kind == "ssm":
        out["ssm"] = _ssm_shapes(cfg, L)
        return out
    out["norm2"] = (L, D)
    out["attn"] = _attn_shapes(cfg, L)
    if stage.kind == "hybrid":
        out["ssm"] = _ssm_shapes(cfg, L)
    if stage.kind == "moe":
        out["moe"] = _moe_shapes(cfg, L)
    else:
        out["mlp"] = _mlp_shapes(cfg, L)
    if stage.kind == "dec_cross":
        out["norm_cross"] = (L, D)
        out["cross"] = _attn_shapes(cfg, L)
    return out


def param_shapes(cfg: ArchConfig, model_parallel: int = 1) -> Dict[str, Any]:
    check_supported(cfg)
    V = cfg.padded_vocab(model_parallel)
    D = cfg.d_model
    shapes: Dict[str, Any] = {
        "embed": (V, D),
        "out_embed": (V, D),
        "final_norm": (D,),
        "stages": [{"layers": stage_param_shapes(cfg, s)}
                   for s in build_stages(cfg)],
    }
    es = enc_stage(cfg)
    if es is not None:
        shapes["enc"] = {"stages": [{"layers": stage_param_shapes(cfg, es)}],
                         "final_norm": (D,)}
    return shapes


def _leaves(tree, path=()):
    """(path, leaf) pairs in the order of ``jax.tree_util``'s flatten:
    dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map(tree, fn, path=()):
    """``fn(path, leaf)`` over the tree; dicts are built in sorted key
    order, ``jax.tree``'s, so every walk of the params meets the leaves in
    the reference's order."""
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


_NO_INIT_SCALE = {"norm1", "norm2", "norm_cross", "final_norm", "norm",
                  "A_log", "D_skip", "dt_bias"}


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32,
                model_parallel: int = 1) -> Dict[str, Any]:
    """Random initialisation by the JAX package's recipe: zero norms
    (RMSNorm scales by 1 + gamma), ``A_log = log(1..h)``, ``D_skip = 1``,
    ``dt_bias = log(expm1(0.01))``, every other leaf ``normal /
    sqrt(fan_in)`` with the reference's fan_in ``shape[-2]`` (D for the
    router and the experts' gate and up weights, F for their down
    weights), and ``out_embed`` tied to ``embed`` when the config
    ties them.  The normals are drawn from ``generator`` (on its own
    device, leaf by leaf in the reference's flatten order), so they differ
    from ``jax.random``'s for the same seed: to compare with the reference,
    carry its weights across with ``params_from_reference``."""
    device = torch.device(device)
    D = cfg.d_model

    def make(path, shape):
        name = path[-1]
        if name in ("norm1", "norm2", "norm_cross", "final_norm", "norm"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if name == "A_log":
            row = torch.log(torch.arange(1, shape[-1] + 1,
                                         dtype=torch.float32))
            return row.expand(shape).contiguous().to(device)
        if name == "D_skip":
            return torch.ones(shape, dtype=torch.float32, device=device)
        if name == "dt_bias":
            return torch.full(shape, math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=device)
        fan_in = shape[-2] if len(shape) >= 2 else D
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        w *= 1.0 / math.sqrt(max(fan_in, 1))
        return w.to(device=device, dtype=dtype)

    shapes = param_shapes(cfg, model_parallel)
    leaves = {path: make(path, shape) for path, shape in _leaves(shapes)}
    params = _map(shapes, lambda path, _: leaves[path])
    if cfg.tie_embeddings:
        params["out_embed"] = params["embed"]
    return params


def abstract_params(cfg: ArchConfig, model_parallel: int = 1,
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The parameter tree as tensors on the ``meta`` device (shapes and
    dtypes, no storage): ``dtype``, but float32 for the norms and the SSM
    scalars (the reference's ``_NO_INIT_SCALE`` leaves), as the reference's
    ``abstract_params`` gives them."""
    def make(path, shape):
        dt = torch.float32 if path[-1] in _NO_INIT_SCALE else dtype
        return torch.empty(shape, dtype=dt, device="meta")
    return _map(param_shapes(cfg, model_parallel), make)


def params_from_reference(tree: Dict[str, Any], cfg: ArchConfig,
                          device="cuda",
                          model_parallel: int = 1) -> Dict[str, Any]:
    """The port's parameters from the JAX package's, as numpy arrays
    (``jax.tree.map(np.asarray, repro.models.model_zoo.init_params(...))``):
    the same tree, each leaf the same values on ``device``."""
    shapes = param_shapes(cfg, model_parallel)

    def take(path, shape):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        arr = np.asarray(leaf)
        if arr.shape != tuple(shape):
            raise ValueError(f"reference leaf {path} has shape {arr.shape}, "
                             f"expected {tuple(shape)}")
        return torch.from_numpy(np.array(arr)).to(device)

    params = _map(shapes, take)
    if cfg.tie_embeddings:
        params["out_embed"] = params["embed"]
    return params


def n_params(params: Dict[str, Any]) -> int:
    """Distinct parameters (a tied ``out_embed`` counted once)."""
    seen = {}
    for _, t in _leaves(params):
        seen[id(t)] = t.numel()
    return sum(seen.values())


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_in(params, cfg: ArchConfig, ids, ctx: ModelContext):
    if ctx.mesh is not None and ctx.embed_method == "rr" and ids.dim() == 2:
        h = emb.embed_lookup_sharded(coll.whole(params["embed"]), ids,
                                     ctx.mesh)
    elif ctx.mesh is not None:
        raise NotImplementedError(
            f"the vocab-sharded table is looked up by 'rr' on (B, S) ids; "
            f"got {ctx.embed_method!r} on ids of shape {tuple(ids.shape)}")
    else:
        h = emb.embed_lookup(params["embed"], ids, method=ctx.embed_method)
    if cfg.tie_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def _mask_pad_vocab(logits: torch.Tensor, vocab: int,
                    first: int = 0) -> torch.Tensor:
    """The padded vocabulary's columns set to -2^30; the logits' columns
    are ``first, first + 1, ...`` (a vocab shard's, on the mesh)."""
    V = logits.shape[-1]
    if first + V <= vocab:
        return logits
    iota = torch.arange(first, first + V, device=logits.device)
    return torch.where(iota < vocab, logits, NEG_INF_F32)


def _vocab_first(logits: torch.Tensor, mesh) -> int:
    """The first vocab column of this rank's logits."""
    return 0 if mesh is None else mesh.model_rank * logits.shape[-1]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _run_encoder(params, cfg: ArchConfig, ctx: ModelContext,
                 enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over (B, enc_seq, D) frame embeddings: its stage
    (unmasked self-attention) and final norm.  None for a decoder-only
    model."""
    if not cfg.enc_dec:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: pass "
                         "enc_embeds, the (B, enc_seq, d_model) frame "
                         "embeddings")
    B, Se, _ = enc_embeds.shape
    h, _, _ = apply_stage_seq(enc_embeds, params["enc"]["stages"][0],
                              enc_stage(cfg), cfg, ctx,
                              _positions(B, Se, enc_embeds.device))
    return rms_norm(h, coll.whole(params["enc"]["final_norm"]),
                    cfg.norm_eps)


def forward_logits(params, cfg: ArchConfig, ctx: ModelContext,
                   tokens: torch.Tensor, enc_embeds=None):
    """tokens: (B, S) -> (logits (B, S, V_pad) float32, aux loss).  On the
    mesh (``ctx.mesh``) ``tokens`` is this rank's data slice and the
    logits its vocab columns (B_loc, S, V_pad / mp)."""
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    h = _embed_in(params, cfg, tokens, ctx)
    enc_out = _run_encoder(params, cfg, ctx, enc_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for sp, stage in zip(params["stages"], build_stages(cfg)):
        h, _, aux = apply_stage_seq(h, sp, stage, cfg, ctx, pos,
                                    enc_out=enc_out)
        aux_total = aux_total + aux
    h = rms_norm(h, coll.whole(params["final_norm"]), cfg.norm_eps)
    logits = emb.logits_matmul(h, coll.whole(params["out_embed"]), ctx.mesh)
    return (_mask_pad_vocab(logits, cfg.vocab, _vocab_first(logits, ctx.mesh)),
            aux_total)


def loss_fn(params, cfg: ArchConfig, ctx: ModelContext, batch,
            aux_weight: float = 0.01):
    """Next-token cross-entropy (+ the MoE load-balance aux loss): labels
    are the tokens rolled left by one, the last position masked.
    ``batch``: {"tokens": (B, S) int, "enc_embeds": (B, enc_seq, D) for an
    encoder-decoder model}.  Returns (loss, {"nll", "aux"}).

    On the mesh ``batch`` is this rank's data slice and the loss the
    global one: the masked mean over every slice's tokens (its numerator
    and count summed over the data group), and the aux loss the mean of
    every rank's (``moe_ffn_ep``); each is replicated, and a rank's
    gradient is its own slice's part of the whole."""
    tokens = batch["tokens"]
    logits, aux = forward_logits(params, cfg, ctx, tokens,
                                 enc_embeds=batch.get("enc_embeds"))
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=labels.device)
    mask[:, -1] = 0.0
    nll = emb.softmax_xent(logits, labels, mask, ctx.mesh)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache build, prefill, decode
# ---------------------------------------------------------------------------

def _stage_cache_len(stage: StageSpec, seq_len: int) -> int:
    return min(stage.window, seq_len) if stage.window else seq_len


def _build_cache(cfg: ArchConfig, B: int, seq_len: int, mk):
    """The cache tree of ``mk(shape, dtype key)`` leaves (the JAX package's
    layout)."""
    K, hd = cfg.n_kv_heads, cfg.hd
    caches = []
    for stage in build_stages(cfg):
        L = stage.n_layers
        c: Dict[str, Any] = {}
        clen = _stage_cache_len(stage, seq_len)
        if stage.kind in ("dense", "hybrid", "moe", "dec_cross"):
            c["k"] = mk((L, B, clen, K, hd), "act")
            c["v"] = mk((L, B, clen, K, hd), "act")
            c["k_pos"] = mk((B, clen), "int")
        if stage.kind in ("ssm", "hybrid"):
            di, gn = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
            w = cfg.ssm.conv_width
            c["conv"] = (mk((L, B, w - 1, di), "act"),
                         mk((L, B, w - 1, gn), "act"),
                         mk((L, B, w - 1, gn), "act"))
            c["state"] = mk((L, B, cfg.n_ssm_heads, cfg.ssm.head_dim,
                             cfg.ssm.d_state), "f32")
        caches.append(c)
    out = {"stages": caches, "pos": mk((B,), "int")}
    if cfg.enc_dec:
        out["enc_out"] = mk((B, cfg.enc_seq, cfg.d_model), "act")
    return out


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A cache leaf's shape and dtype without a tensor: what the placement
    rules and ``local_shape`` read (a tensor, even on the ``meta`` device,
    would count as an allocation of the whole global cache to a dry
    run's recorders)."""
    shape: tuple
    dtype: torch.dtype = torch.float32


def cache_placement(cfg: ArchConfig, B: int, seq_len: int, mesh):
    """``cache_specs`` of the cache for a global batch ``B`` at context
    ``seq_len`` on ``mesh``."""
    shape = ShapeConfig("serve", seq_len, B, "decode")
    return sh.cache_specs(cfg, shape, mesh, _build_cache(
        cfg, B, seq_len, lambda s, _: _Leaf(tuple(s))))


def build_cache(cfg: ArchConfig, B: int, seq_len: int, ctx: ModelContext,
                dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """An empty cache for decode at context ``seq_len`` (zeros; the JAX
    package's layout); on the mesh this rank's block of ``cache_specs``
    for the global batch ``B``."""
    check_supported(cfg)
    types = {"act": dtype, "int": torch.int32, "f32": torch.float32}
    if ctx.mesh is None:
        return _build_cache(cfg, B, seq_len, lambda s, t: torch.zeros(
            s, dtype=types[t], device=device))
    specs = cache_placement(cfg, B, seq_len, ctx.mesh)
    whole = _build_cache(cfg, B, seq_len,
                         lambda s, t: _Leaf(tuple(s), types[t]))
    return sh._zip(whole, specs, lambda _, t, spec: torch.zeros(
        sh.local_shape(spec, t.shape, ctx.mesh), dtype=t.dtype,
        device=device))


def _data_rows(x: torch.Tensor, mesh, batch_split: bool) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (all of them where the
    batch does not split over the data axes)."""
    if mesh is None or not batch_split:
        return x
    b = x.shape[0] // mesh.data_size
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]


def _seq_group(spec, mesh):
    """(process group, block index) of a stage cache's sequence axis under
    its ``k`` spec (None: whole on each rank)."""
    e = spec[2]
    if e is None:
        return None
    if e == "model":
        return mesh.model_group, mesh.model_rank
    if tuple(e) != tuple(mesh.axis_names):
        raise NotImplementedError(f"a cache sequence axis over {e}")
    return dist.group.WORLD, mesh.rank


def _block(t: torch.Tensor, dim: int, split, index: int) -> torch.Tensor:
    """Block ``index`` of ``t`` along ``dim`` in ``split`` parts (``t``
    itself for one part)."""
    if split <= 1:
        return t
    n = t.shape[dim] // split
    return t.narrow(dim, index * n, n).contiguous()


def _place_stage_cache(cache: dict, specs: dict, cfg: ArchConfig,
                       mesh) -> dict:
    """A stage's prefill cache (this rank's rows; its kv heads, or all of
    them where ``wk`` is whole; its SSM columns and heads, or all) cut to
    its block of ``specs``: the kv heads gathered over the model group,
    then the rank's block of slots; where the cache splits a conv block
    that the weights keep whole (d_inner / mp not a multiple of the SSM
    head dim: Hymba-1.5B at mp 16), the rank's columns.  The state splits
    exactly where the SSM's heads do."""
    mp = mesh.model_size
    out = dict(cache)
    if "k" in cache:
        sg = _seq_group(specs["k"], mesh)
        parts, index = ((1, 0) if sg is None else
                        (coll.group_size(sg[0]), sg[1]))
        for name in ("k", "v"):
            t = cache[name]
            if t.shape[3] < cfg.n_kv_heads:
                t = coll.gather_slices(t, mesh.model_group, dim=3)
            out[name] = _block(t, 2, parts, index)
        out["k_pos"] = _block(cache["k_pos"], 1, parts, index)
    if "conv" in cache:
        out["conv"] = tuple(
            _block(c, 3, mp if sp[3] == "model" and c.shape[3] == whole
                   else 1, mesh.model_rank)
            for c, sp, whole in zip(cache["conv"], specs["conv"],
                                    (cfg.d_inner,) + (cfg.ssm.n_groups
                                                      * cfg.ssm.d_state,) * 2))
    return out


def prefill(params, cfg: ArchConfig, ctx: ModelContext, tokens: torch.Tensor,
            enc_embeds=None, max_len: int = 0):
    """tokens: (B, S); enc_embeds: (B, enc_seq, D) frame embeddings of an
    encoder-decoder model.  Returns (last-token logits (B, V_pad), cache).

    ``max_len`` sets the global-attention cache capacity (>= S + the
    decode steps to come); window stages always hold ``window`` slots.

    On the mesh (``ctx.mesh``) ``tokens`` and ``enc_embeds`` are the
    global batch, of which the rank runs its data slice (all of it where
    the batch does not split over the data axes), and the results are
    its blocks of ``logits_spec`` (its rows, its vocab columns) and of
    ``cache_specs`` (``cache_placement``)."""
    mesh = ctx.mesh
    B, S = tokens.shape
    max_len = max(max_len, S)
    specs = None
    if mesh is not None:
        specs = cache_placement(cfg, B, max_len, mesh)
        split = specs["pos"][0] is not None
        tokens = _data_rows(tokens, mesh, split)
        if enc_embeds is not None:
            enc_embeds = _data_rows(enc_embeds, mesh, split)
        B = tokens.shape[0]
    pos = _positions(B, S, tokens.device)
    h = _embed_in(params, cfg, tokens, ctx)
    enc_out = _run_encoder(params, cfg, ctx, enc_embeds)
    caches = []
    for i, (sp, stage) in enumerate(zip(params["stages"],
                                        build_stages(cfg))):
        clen = _stage_cache_len(stage, max_len)
        h, cache, _ = apply_stage_seq(h, sp, stage, cfg, ctx, pos,
                                      enc_out=enc_out, want_cache=True,
                                      cache_len=clen)
        if stage.kind != "ssm":
            cache["k_pos"] = stage_kpos(B, S, clen, tokens.device)
        if mesh is not None:
            cache = _place_stage_cache(cache, specs["stages"][i], cfg, mesh)
        caches.append(cache)
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = emb.logits_matmul(h, params["out_embed"], mesh)[:, 0]
    out = {"stages": caches,
           "pos": torch.full((B,), S, dtype=torch.int32,
                             device=tokens.device)}
    if cfg.enc_dec:
        out["enc_out"] = enc_out
    return _mask_pad_vocab(logits, cfg.vocab, _vocab_first(logits, mesh)), out


def decode_step(params, cfg: ArchConfig, ctx: ModelContext,
                token: torch.Tensor, cache: Dict[str, Any],
                max_len: int = 0):
    """token: (B, 1) int; cache from prefill/build_cache.  Returns (logits
    (B, V_pad), new cache).  The K/V ring buffers are written in place
    (see ``apply_stage_decode``).

    On the mesh ``token`` is the global batch, ``cache`` this rank's block
    and ``max_len`` the context that ``prefill`` / ``build_cache`` placed
    it for (``cache_specs`` splits by it); the logits are the rank's block
    of ``logits_spec``."""
    mesh = ctx.mesh
    seq = None
    if mesh is not None:
        if max_len <= 0:
            raise ValueError("decode_step on the mesh needs max_len, the "
                             "context the cache was placed for")
        specs = cache_placement(cfg, token.shape[0], max_len, mesh)
        token = _data_rows(token, mesh, specs["pos"][0] is not None)
        seq = [_seq_group(s["k"], mesh) if "k" in s else None
               for s in specs["stages"]]
    pos = cache["pos"]
    h = _embed_in(params, cfg, token, ctx)
    enc_out = cache.get("enc_out")
    new_stages = []
    for i, (sp, stage, sc) in enumerate(zip(params["stages"],
                                            build_stages(cfg),
                                            cache["stages"])):
        h, nc = apply_stage_decode(h, sp, stage, cfg, ctx, pos, sc,
                                   enc_out=enc_out,
                                   seq_group=None if seq is None else seq[i])
        new_stages.append(nc)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = emb.logits_matmul(h, params["out_embed"], mesh)[:, 0]
    new_cache = {"stages": new_stages, "pos": pos + 1}
    if cfg.enc_dec:
        new_cache["enc_out"] = enc_out
    return (_mask_pad_vocab(logits, cfg.vocab, _vocab_first(logits, mesh)),
            new_cache)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 tokens (first maximum on ties, as
    ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

