"""Stage-structured transformer backbone -- the port of
``repro.models.transformer``: the stage kinds ``dense``, ``ssm``,
``hybrid``, ``moe``, and the encoder-decoder's ``enc`` and ``dec_cross``.

A model is a list of **stages**; each stage is a stack of homogeneous
layers whose parameters are stacked on a leading axis, exactly as the JAX
package lays them out, and applied in a Python loop over that axis.
Heterogeneous layer patterns (hymba's sparse global layers) become several
stages; caches are per stage, so sliding-window stages hold only
``window`` KV slots, written as a ring buffer (slot = position % window).

Modes:
  forward -- full causal forward, logits at every position
  prefill -- the same forward, also emits the KV/SSM caches
  decode  -- one token against the caches (ring-buffer windows, SSM state)

An encoder-decoder model (Whisper) runs its ``enc`` stage, unmasked
self-attention over the frame embeddings, once a request; each
``dec_cross`` layer adds cross-attention to the encoder's output after its
self-attention.  The cross K/V are projected from ``enc_out`` again at
every call, decode steps included, as the reference does.

Training (``apply_stage_seq`` without caches) recomputes each layer in
the backward pass under ``ModelContext.remat``, as the reference wraps
each layer in ``jax.checkpoint``: ``"full"`` keeps only each layer's
input (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` also keeps
the outputs of the weight products (a selective-checkpoint policy, the
counterpart of ``dots_with_no_batch_dims_saveable``), ``"none"`` keeps
every activation.  The recomputation records no MoE routing a second
time (``moe.record`` is off while it runs).

A ``moe`` stage runs on one device (``moe_ffn_ref``) or, with
``ModelContext.moe``, expert-parallel over ``torch.distributed``: every
rank runs the whole model on all the tokens, and each MoE layer hands
each rank its slice of the tokens (padded to a multiple of the ranks),
runs ``moe_ffn_ep`` and gathers the slices back, as the reference's
``shard_map`` does.  Under ``ModelContext.mesh`` the same happens within
each data slice over the mesh's model group.  The stage's aux loss is the
sum of its layers'.

Under ``ModelContext.mesh`` the attention (self and cross), MLP and SSM
blocks are tensor-parallel over the model group wherever their leaves
hold this rank's shard (``launch.shardings.placement_specs``): each rank
runs its heads or columns and the row-parallel outputs are summed
(``layers``, ``ssm``); a block whose leaves stay whole runs whole on
every rank.  A hybrid layer adds the replicated or summed attention and
the summed SSM output, each once.  The decode step takes the cache as
``cache_specs`` places it: all kv heads of the rank's block of slots
(``seq_group``, when the sequence axis is split), so the new token's
query, key and value are gathered over the model group, the key and
value written by the rank that owns the slot, and the slots' softmax
combined over the sequence group (``layers.decode_attention_split``);
the SSM's conv and state blocks are its columns and heads.

Under fsdp (``train_state_specs(fsdp=True)``) the training step hands the
model its blocks of the leaves split over the data axes as
``collectives.DataBlock``s: each layer gathers its own inside the function
that remat recomputes, and the model gathers ``embed``, ``out_embed`` and
the final norms where it uses them.  A moe stage's routed expert stacks
may hold this rank's E / mp experts (stored expert shards) or all E
(``moe_ffn_ep`` decides by their shape).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (KERNEL_MODES, NEG_INF, AttnSpec,
                                       apply_rope, attn_block,
                                       decode_attention_split, head_shard,
                                       rms_norm, swiglu)
from repro_torch.models import collectives as coll
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import MoEContext, moe_ffn_ep, moe_ffn_ref
from repro_torch.models.ssm import mamba_block

SUPPORTED_KINDS = ("dense", "ssm", "hybrid", "moe", "enc", "dec_cross")
REMAT_MODES = ("full", "dots", "none")
EMBED_METHODS = ("gather", "onehot", "rr")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str        # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'enc' | 'dec_cross'
    n_layers: int
    window: int = 0  # 0 = global attention


def build_stages(cfg: ArchConfig) -> List[StageSpec]:
    if cfg.family == "ssm":
        return [StageSpec("ssm", cfg.n_layers)]
    if cfg.is_moe:
        return [StageSpec("moe", cfg.n_layers)]
    kind = "hybrid" if cfg.family == "hybrid" else "dense"
    if cfg.enc_dec:
        kind = "dec_cross"
    if not cfg.sliding_window:
        return [StageSpec(kind, cfg.n_layers)]
    stages, run_w, run_n = [], None, 0
    for i in range(1, cfg.n_layers + 1):
        w = 0 if (cfg.global_every and i % cfg.global_every == 0) \
            else cfg.sliding_window
        if w == run_w:
            run_n += 1
        else:
            if run_n:
                stages.append(StageSpec(kind, run_n, run_w))
            run_w, run_n = w, 1
    stages.append(StageSpec(kind, run_n, run_w))
    return stages


def enc_stage(cfg: ArchConfig) -> Optional[StageSpec]:
    return StageSpec("enc", cfg.n_enc_layers) if cfg.enc_dec else None


def check_kind(stage: StageSpec) -> None:
    """Raise for a stage of a kind the port does not know."""
    if stage.kind not in SUPPORTED_KINDS:
        raise NotImplementedError(f"stage kind {stage.kind!r} is not one "
                                  f"the port runs: {SUPPORTED_KINDS}")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a configuration with a stage kind the port does not
    know."""
    stages = build_stages(cfg)
    if cfg.enc_dec:
        stages.append(enc_stage(cfg))
    for stage in stages:
        check_kind(stage)


@dataclasses.dataclass(frozen=True)
class ModelContext:
    """Implementation knobs: the plain path's query-chunking threshold (the
    reference's), the kernel mode, the MoE layers' expert parallelism
    (``moe``; None: one device), the token lookup (``embed_method``, the
    reference's ``gather | onehot | rr``) and the per-layer recomputation
    of training (``remat``, the reference's ``full | dots | none``;
    serving builds caches and never recomputes).

    ``mesh`` (a ``launch.mesh.Mesh``; None: no mesh) is the reference's
    training mesh, with its ``dp_axes`` and ``ep_axis``: each rank runs its
    data slice, ``embed`` and ``out_embed`` hold this rank's vocab rows,
    the MoE layers split the slice's tokens over the model group,
    which is also their EP group (``moe`` must then be None), and the
    attention, MLP and SSM blocks whose leaves hold this rank's shard run
    tensor-parallel over the same group (``tp_group``)."""
    q_chunk: int = 1024
    kernels: str = "auto"          # "auto" | "kernel" | "ref" (layers.py)
    moe: Optional[MoEContext] = None
    embed_method: str = "rr"       # gather | onehot | rr (paper technique)
    remat: str = "full"            # full | dots | none
    mesh: Optional[object] = None
    dp_axes: tuple = ("data",)
    ep_axis: str = "model"

    def __post_init__(self):
        if self.mesh is not None:
            if self.moe is not None:
                raise ValueError("under a mesh the MoE layers take their EP "
                                 "group from the mesh: leave moe None")
            if self.ep_axis != "model" or tuple(self.dp_axes) != tuple(
                    a for a in self.mesh.axis_names if a in ("pod", "data")):
                raise ValueError(f"dp_axes {self.dp_axes} and ep_axis "
                                 f"{self.ep_axis!r} are not the mesh's "
                                 f"{self.mesh.axis_names}")
        for name, value, allowed in (("kernel mode", self.kernels,
                                      KERNEL_MODES),
                                     ("embed method", self.embed_method,
                                      EMBED_METHODS),
                                     ("remat mode", self.remat,
                                      REMAT_MODES)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}; use one of "
                                 f"{allowed}")

    @property
    def n_devices(self) -> int:
        """The mesh's size; without a mesh the ranks that shard the MoE
        layers' tokens (1 on one device)."""
        if self.mesh is not None:
            return self.mesh.size
        return 1 if self.moe is None else dist.get_world_size()

    @property
    def token_group(self):
        """The process group whose ranks split an MoE layer's tokens (the
        model group under a mesh, the default group under ``moe``; None
        on one device)."""
        if self.mesh is not None:
            return self.mesh.model_group
        return None if self.moe is None else dist.group.WORLD

    @property
    def tp_group(self):
        """The model group of the tensor-parallel blocks (None without a
        mesh, or on a model axis of one)."""
        if self.mesh is None or self.mesh.model_size == 1:
            return None
        return self.mesh.model_group

    def split(self, local: int, whole: int):
        """``tp_group`` where a block's leaf holds ``local`` of its
        ``whole`` heads or columns (this rank's shard), else None."""
        return self.tp_group if local != whole else None

    @property
    def moe_context(self) -> Optional[MoEContext]:
        """The MoE layers' expert parallelism: the mesh's model group as
        the EP group, as the reference's ``_moe_call`` builds its
        ``MoEContext`` from ``ctx.mesh``; else ``moe``."""
        if self.mesh is not None:
            return MoEContext(ep_group=self.mesh.model_group)
        return self.moe


def _moe_call(x2d, w, cfg: ArchConfig, ctx: ModelContext):
    """The MoE FFN over (T, D) tokens, T a multiple of the token group's
    size: on one device ``moe_ffn_ref``; under expert parallelism this
    rank's slice (the reference's token spec ``P((*dp, ep))``) through
    ``moe_ffn_ep``, the slices then gathered on every rank of the group.
    Differentiable: the slice's backward gathers the cotangent's slices,
    the gather's keeps this rank's (``models.collectives``)."""
    mctx = ctx.moe_context
    if mctx is None:
        return moe_ffn_ref(x2d, w, cfg.moe)
    group = ctx.token_group
    xs = coll.split_slices(x2d, group)
    y, aux = moe_ffn_ep(xs, w, cfg.moe, mctx)
    return coll.gather_slices(y, group), aux


def _moe_update(h, w, cfg: ArchConfig, ctx: ModelContext):
    """h + the MoE FFN of rms_norm(h, norm2), over the tokens flattened to
    (T, D) and padded with zero rows to a multiple of the ranks that split
    them.  Returns (h, aux)."""
    xm = rms_norm(h, w["norm2"], cfg.norm_eps)
    x2 = xm.reshape(-1, xm.shape[-1])
    T = x2.shape[0]
    pad = -T % coll.group_size(ctx.token_group)
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    y, aux = _moe_call(x2, w["moe"], cfg, ctx)
    return h + y[:T].reshape(h.shape), aux


def _attn_spec(cfg: ArchConfig, window: int, ctx: ModelContext,
               causal: bool = True) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd, rope_theta=cfg.rope_theta, causal=causal,
                    window=window, q_chunk=ctx.q_chunk, kernels=ctx.kernels)


def _cross_attend(h, w, spec: AttnSpec, cfg: ArchConfig, q_pos, enc_out,
                  ctx: Optional[ModelContext] = None):
    """The ``dec_cross`` layer's cross-attention update: the queries of
    rms_norm(h, norm_cross) at ``q_pos`` against the K/V projected from
    ``enc_out`` (B, Se, D) at the frames' positions 0..Se-1, unmasked
    (through the flash kernel on the card under "auto"); on this rank's
    heads where ``cross`` is split (``enc_out`` then enters through
    ``sum_cotangents``)."""
    B, Se = enc_out.shape[0], enc_out.shape[1]
    group = (None if ctx is None
             else ctx.split(w["cross"]["wq"].shape[-2], cfg.n_heads))
    cpos = torch.arange(Se, dtype=torch.int32,
                        device=enc_out.device).expand(B, Se)
    enc = enc_out if group is None else coll.sum_cotangents(enc_out, group)
    ck = torch.einsum("bsd,dhk->bshk", enc, w["cross"]["wk"])
    cv = torch.einsum("bsd,dhk->bshk", enc, w["cross"]["wv"])
    cspec = dataclasses.replace(spec, causal=False, window=0)
    return attn_block(rms_norm(h, w["norm_cross"], cfg.norm_eps),
                      w["cross"], cspec, q_pos, cross_kv=(ck, cv),
                      cross_pos=cpos, group=group)


def _groups(w: dict, cfg: ArchConfig, ctx: ModelContext) -> dict:
    """The tensor-parallel group of each block of a layer (None where its
    leaves are whole)."""
    out = {}
    if "attn" in w:
        out["attn"] = ctx.split(w["attn"]["wq"].shape[-2], cfg.n_heads)
    if "ssm" in w:
        out["ssm"] = ctx.split(w["ssm"]["wx"].shape[-1], cfg.d_inner)
    if "mlp" in w:
        out["mlp"] = ctx.split(w["mlp"]["w_gate"].shape[-1], cfg.d_ff)
    return out


def _layer(sp: dict, i: int) -> dict:
    """Layer ``i``'s weights out of a stage's stacked ones (views; an fsdp
    leaf's ``DataBlock.layer``)."""
    return {k: _layer(v, i) if isinstance(v, dict) else (
        v.layer(i) if isinstance(v, coll.DataBlock) else v[i])
        for k, v in sp.items()}


def _gathered(w: dict) -> dict:
    """A layer's weights with every fsdp block made whole over the data
    group (``collectives.whole``)."""
    return {k: _gathered(v) if isinstance(v, dict) else coll.whole(v)
            for k, v in w.items()}


def _stack(per_layer: List[dict]) -> dict:
    out = {}
    for k, v in per_layer[0].items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.stack([c[k][j] for c in per_layer])
                           for j in range(len(v)))
        else:
            out[k] = torch.stack([c[k] for c in per_layer])
    return out


# ---------------------------------------------------------------------------
# full-sequence stage application (forward / prefill)
# ---------------------------------------------------------------------------

def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of products with no batch
    dimension (``mm``, ``addmm``, and ``bmm`` over a batch of one, which
    is what the weight einsums lower to), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _recomputing(inner):
    """The recomputation's context: ``inner`` (the selective policy's, or
    none) with ``moe.record`` off, so no layer's routing is recorded
    twice."""
    saved = moe_mod.record
    moe_mod.record = None
    try:
        with inner:
            yield
    finally:
        moe_mod.record = saved


def _remat(layer, remat: str, *args):
    """``layer(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the layer's activations are recomputed in the backward pass ("full"),
    all but the weight products' outputs ("dots").  The layers draw no
    random numbers, so the RNG state is not stashed."""
    from torch.utils import checkpoint as ckpt

    def contexts():
        if remat == "dots":
            fwd, rec = ckpt.create_selective_checkpoint_contexts(
                _save_weight_products)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _recomputing(rec)
    return ckpt.checkpoint(layer, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=contexts)


def apply_stage_seq(h, sp, stage: StageSpec, cfg: ArchConfig,
                    ctx: ModelContext, positions, enc_out=None,
                    want_cache=False, cache_len=0):
    """Run one stacked stage over the full sequence (``enc_out``: the
    encoder's output, for a ``dec_cross`` stage); without caches each
    layer runs under ``ctx.remat``, as the reference's.
    Returns (h, stacked layer caches: dict, aux loss: scalar)."""
    check_kind(stage)
    spec = _attn_spec(cfg, stage.window, ctx, causal=stage.kind != "enc")

    def layer(h, w):
        """One layer: (h, aux loss or None, cache); its fsdp blocks are
        gathered here, inside the recomputed function, so that the backward
        gathers them again rather than keep them."""
        w = _gathered(w)
        cache, aux = {}, None
        groups = _groups(w, cfg, ctx)
        xn = rms_norm(h, w["norm1"], cfg.norm_eps)
        if stage.kind == "ssm":
            y, (cst, sst) = mamba_block(xn, w["ssm"], cfg.ssm, cfg.d_model,
                                        kernels=ctx.kernels,
                                        group=groups["ssm"])
            h = h + y
            if want_cache:
                cache = {"conv": cst, "state": sst}
            return h, aux, cache
        a = attn_block(xn, w["attn"], spec, positions, return_kv=want_cache,
                       group=groups["attn"])
        if want_cache:
            a, (kf, vf) = a
        if stage.kind == "hybrid":
            m, (cst, sst) = mamba_block(xn, w["ssm"], cfg.ssm, cfg.d_model,
                                        kernels=ctx.kernels,
                                        group=groups["ssm"])
            h = h + a + m
        else:
            h = h + a
        if stage.kind == "dec_cross":
            h = h + _cross_attend(h, w, spec, cfg, positions, enc_out, ctx)
        if stage.kind == "moe":
            h, aux = _moe_update(h, w, cfg, ctx)
        else:
            h = h + swiglu(rms_norm(h, w["norm2"], cfg.norm_eps), w["mlp"],
                           groups["mlp"])
        if want_cache:
            kc, vc = _tail_cache(kf, vf, cache_len)
            cache = {"k": kc, "v": vc}
            if stage.kind == "hybrid":
                cache.update(conv=cst, state=sst)
        return h, aux, cache

    # nothing to recompute without a backward pass (serving, no_grad)
    remat = (ctx.remat if not want_cache and torch.is_grad_enabled()
             and ctx.remat != "none" else None)
    per_layer = []
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(stage.n_layers):
        w = _layer(sp["layers"], i)
        if remat is None:
            h, aux, cache = layer(h, w)
        else:
            h, aux, cache = _remat(layer, remat, h, w)
        if aux is not None:
            aux_total = aux_total + aux
        per_layer.append(cache)
    caches = _stack(per_layer) if want_cache else {}
    return h, caches, aux_total


def _tail_cache(k, v, cache_len: int):
    """Keep the last ``cache_len`` positions of already-computed rotated K/V
    in ring-buffer layout (slot = pos % cache_len)."""
    S = k.shape[1]
    if cache_len >= S:
        pad = (0, 0, 0, 0, 0, cache_len - S)
        return (torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad))
    tail_k, tail_v = k[:, -cache_len:], v[:, -cache_len:]
    shift = S % cache_len
    return (torch.roll(tail_k, shift, dims=1),
            torch.roll(tail_v, shift, dims=1))


def stage_kpos(B: int, S: int, clen: int, device=None) -> torch.Tensor:
    """Positions held by each ring-buffer slot after prefilling S tokens
    (-1: empty)."""
    slots = torch.arange(clen, dtype=torch.int32, device=device)
    if clen >= S:
        p = torch.where(slots < S, slots, -1)
    else:
        # largest p < S with p % clen == slot
        last = S - 1 - (S - 1 - slots) % clen
        p = torch.where(last >= S, last - clen, last)
    return p.expand(B, clen).contiguous()


# ---------------------------------------------------------------------------
# single-token decode stage application
# ---------------------------------------------------------------------------

def _ssm_decode(xn, w, lc, cfg: ArchConfig, group, ctx: ModelContext):
    """The SSM's decode step on this rank's cache blocks: a conv block
    narrower than the columns the rank computes (the cache splits what
    the weights keep whole) is gathered over the model group first and
    cut back after."""
    mg = ctx.tp_group
    widths = (w["wx"].shape[-1], w["wB"].shape[-1], w["wC"].shape[-1])
    conv = tuple(c if c.shape[-1] == n else coll.gather_slices(c, mg, dim=-1)
                 for c, n in zip(lc["conv"], widths))
    y, (cst, sst) = mamba_block(xn, w, cfg.ssm, cfg.d_model,
                                conv_state=conv, ssm_state=lc["state"],
                                decode=True, group=group)
    cst = tuple(c if c.shape[-1] == old.shape[-1] else
                c.narrow(-1, dist.get_rank(mg) * old.shape[-1],
                         old.shape[-1]).contiguous()
                for c, old in zip(cst, lc["conv"]))
    return y, cst, sst


def apply_stage_decode(h, sp, stage: StageSpec, cfg: ArchConfig,
                       ctx: ModelContext, pos, cache, enc_out=None,
                       seq_group=None):
    """h: (B, 1, D); pos: (B,) int; cache: a stage cache {layer leaves...,
    'k_pos'?}; enc_out: the encoder's output, for a ``dec_cross`` stage.
    Returns (h, new_cache).  The K/V ring buffers of ``cache`` are written
    in place (one slot a layer) and shared with the new cache; every other
    leaf is new.

    On the mesh ``cache`` is this rank's block of ``cache_specs``: all kv
    heads, and where ``seq_group`` is a (process group, index) pair, the
    index-th block of the slots (the sequence axis split over the
    group)."""
    check_kind(stage)
    spec = _attn_spec(cfg, stage.window, ctx)
    B = h.shape[0]
    bidx = torch.arange(B, device=h.device)
    k_pos = cache.get("k_pos")
    new_k_pos = None
    sgroup, parts, block = None, 1, 0
    if seq_group is not None and coll.group_size(seq_group[0]) > 1:
        sgroup, block = seq_group
        parts = coll.group_size(sgroup)
    if k_pos is not None:
        clen = k_pos.shape[1]
        slot = (pos % (clen * parts)).long()
        new_k_pos = k_pos.clone()
        if sgroup is None:
            new_k_pos[bidx, slot] = pos.to(k_pos.dtype)
        else:
            # the rank that owns the slot writes it; the others write back
            # what they hold
            mine = slot // clen == block
            slot = slot % clen
            new_k_pos[bidx, slot] = torch.where(mine, pos.to(k_pos.dtype),
                                                k_pos[bidx, slot])
        valid = (new_k_pos >= 0) & (new_k_pos <= pos[:, None])
        if spec.window:
            valid &= new_k_pos > (pos[:, None] - spec.window)
    n_rep = spec.n_heads // max(spec.n_kv_heads, 1)

    def write(c, new):
        if sgroup is None:
            c[bidx, slot] = new.to(c.dtype)
        else:
            c[bidx, slot] = torch.where(mine[:, None, None], new.to(c.dtype),
                                        c[bidx, slot])

    def attend_cached(xn, w, kc, vc, group):
        tp = head_shard(w, spec, group)
        q = torch.einsum("bsd,dhk->bshk", xn, w["wq"])
        q = apply_rope(q, pos[:, None], spec.rope_theta)
        k_new = apply_rope(torch.einsum("bsd,dhk->bshk", xn, w["wk"]),
                           pos[:, None], spec.rope_theta)
        v_new = torch.einsum("bsd,dhk->bshk", xn, w["wv"])
        if tp.group is not None:
            # the new token's heads made whole: q always, k and v where
            # their heads split too (one gather of the packed blocks)
            both = [q] + ([k_new, v_new] if k_new.shape[2] < kc.shape[2]
                          else [])
            widths = [t.shape[2] for t in both]
            got = coll.gather_slices(torch.cat(both, dim=2), tp.group,
                                      dim=2)
            got = got.view(B, 1, -1, sum(widths), q.shape[-1])
            whole = [t.reshape(B, 1, -1, q.shape[-1])
                     for t in got.split(widths, dim=3)]
            q = whole[0]
            if len(whole) == 3:
                k_new, v_new = whole[1], whole[2]
        write(kc, k_new[:, 0])
        write(vc, v_new[:, 0])
        kf = torch.repeat_interleave(kc, n_rep, dim=2) if n_rep > 1 else kc
        vf = torch.repeat_interleave(vc, n_rep, dim=2) if n_rep > 1 else vc
        if sgroup is None:
            scores = (torch.einsum("bqhd,bkhd->bhqk", q, kf).float()
                      * spec.head_dim ** -0.5)
            scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
            p = torch.softmax(scores, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(vf.dtype),
                             vf).to(xn.dtype)
        else:
            o = decode_attention_split(q, kf, vf, valid,
                                       spec.head_dim ** -0.5, sgroup)
        if tp.group is None:
            return torch.einsum("bshk,hkd->bsd", o, w["wo"])
        o = o[:, :, tp.h0:tp.h0 + tp.spec.n_heads]
        return coll.psum_replicated(
            torch.einsum("bshk,hkd->bsd", o, w["wo"]), tp.group)

    per_layer = []
    for i in range(stage.n_layers):
        w = _layer(sp["layers"], i)
        groups = _groups(w, cfg, ctx)
        lc = {k: (tuple(c[i] for c in v) if isinstance(v, tuple) else v[i])
              for k, v in cache.items() if k != "k_pos"}
        xn = rms_norm(h, w["norm1"], cfg.norm_eps)
        if stage.kind == "ssm":
            y, cst, sst = _ssm_decode(xn, w["ssm"], lc, cfg, groups["ssm"],
                                      ctx)
            h = h + y
            per_layer.append({"conv": cst, "state": sst})
            continue
        a = attend_cached(xn, w["attn"], lc["k"], lc["v"], groups["attn"])
        if stage.kind == "hybrid":
            m, cst, sst = _ssm_decode(xn, w["ssm"], lc, cfg, groups["ssm"],
                                      ctx)
            h = h + a + m
        else:
            h = h + a
        if stage.kind == "dec_cross":
            h = h + _cross_attend(h, w, spec, cfg, pos[:, None], enc_out,
                                  ctx)
        if stage.kind == "moe":
            h, _ = _moe_update(h, w, cfg, ctx)
        else:
            h = h + swiglu(rms_norm(h, w["norm2"], cfg.norm_eps), w["mlp"],
                           groups["mlp"])
        nc = {}
        if stage.kind == "hybrid":
            nc.update(conv=cst, state=sst)
        per_layer.append(nc)
    out = _stack(per_layer) if per_layer[0] else {}
    if new_k_pos is not None:
        out["k"], out["v"] = cache["k"], cache["v"]   # written in place
        out["k_pos"] = new_k_pos
    return h, out
