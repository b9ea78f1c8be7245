"""Mixture-of-Experts FFN with the paper's message-reduction techniques --
the port of ``repro.models.moe``.

Mapping of Yan et al.'s ideas onto expert parallelism:

* **Sender-side message combining** (paper §4/§5): tokens headed to the
  same expert are packed into one contiguous per-(sender, expert) buffer
  *before* the ``all_to_all`` -- one batched message per destination rank
  instead of one message per token, the Pregel+ combined channel.
* **Mirroring** (paper §5, Thm 1/2 analog): the ``n_mirrored_experts``
  hottest experts are replicated on every EP rank; tokens routed to them
  are served locally and never enter the all_to_all, bounding the fan-in
  of a hot expert as a mirror bounds a high-degree vertex's fan-out.
  ``repro_torch.core.cost_model.moe_mirror_threshold`` arbitrates between
  replication (weight memory) and message savings.

Dispatch is capacity-bounded (static shapes): ``cap`` tokens per (sender
rank, expert); overflow tokens are dropped with zero contribution, the
Switch/GShard semantics.  Two implementations with the same math:

* ``moe_ffn_ref`` -- the single-buffer reference (one device).
* ``moe_ffn_ep``  -- expert parallelism over ``torch.distributed``: each
  rank holds a slice of the tokens and a shard of the experts of its EP
  group (``MoEContext``), and the combined buffers travel in one
  ``all_to_all_single`` each way.  It is differentiable as the
  reference's ``shard_map`` is: the exchanges' backward is the reverse
  exchange, and the aux loss's mean over the ranks (a replicated sum)
  passes its cotangent through (``models.collectives``).  A rank's
  gradient of the router, the mirrored experts and its own expert rows
  covers its tokens only: summed over the ranks that split the tokens,
  they are the reference's.

Routing statistics: while ``record`` is a list, every MoE call appends a
dict of device tensors (no host sync) describing its dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import MoEConfig
from repro_torch.models import collectives as coll
from repro_torch.models.layers import silu

record: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class MoEContext:
    """How the MoE layer is distributed (the reference's mesh axes):
    ``ep_group`` is the process group that shards the experts (its
    ``ep_axis``); the default group's ranks shard the tokens and average
    the aux loss (its dp axes and ep axis together).  The local path has
    no context (``ModelContext.moe`` is None)."""
    ep_group: object


def ep_context(dp: int, ep: int) -> MoEContext:
    """The (dp, ep) mesh over the default process group of world size
    dp * ep, row-major as the reference's ``("data", "model")`` mesh: rank
    r = d * ep + e holds token slice r and expert shard e, and its EP
    group is ``{d * ep, ..., d * ep + ep - 1}`` (the host group of
    ``launch.mesh.graph_mesh(dp, ep)``)."""
    from repro_torch.launch import mesh as meshlib
    ep_group, _ = meshlib.graph_mesh(dp, ep)
    return MoEContext(ep_group=ep_group)


def router_probs(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Return (gates, expert_idx, probs): top-k router with renormalised
    softmax.  x: (T, D), w_router: (D, E) -> gates (T, k), idx (T, k)."""
    logits = torch.matmul(x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates.to(x.dtype), idx, probs


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``ids`` (int64, (n,)): a
    ``bincount`` of a known length, as a scatter of ones, so that its
    shape does not depend on the values (it runs on the ``meta`` device,
    where ``bincount`` has no kernel)."""
    ids = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E * <f_e> . <p_e>, f_e the mean
    over tokens of the times expert e was chosen."""
    f = _counts(idx, n_experts).float()
    f = f / idx.shape[0]
    p = probs.float().mean(0)
    return n_experts * torch.sum(f * p)


def _expert_mlp(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """xe: (C, D) tokens of one expert, or (E, C, D) batched over experts
    with (E, D, F) / (E, F, D) weights."""
    return torch.matmul(silu(torch.matmul(xe, wg)) * torch.matmul(xe, wu),
                        wd)


def _slots(idx: torch.Tensor, n_experts: int, cap: int,
           mirrored_mask: torch.Tensor):
    """Each (token, slot) pair's place in its expert's queue, in flat
    (T*k) order: (flat_e, slot, send, keep).  ``slot`` is the exclusive
    prefix count of the sent pairs before it with the same expert (0 for
    a pair not sent); ``send`` is False for mirrored experts, ``keep`` =
    send & slot < cap.

    The reference takes the prefix counts as a cumsum down a (T*k, E)
    one-hot; here a stable sort by expert ranks each pair within its
    expert's run, the same counts without the (T*k, E) scan (on the card
    a scan down the outer dim of that one-hot took 43% of an OLMoE
    prefill)."""
    flat_e = idx.reshape(-1).long()
    send = ~mirrored_mask[flat_e]
    key = torch.where(send, flat_e, n_experts)    # pairs not sent: apart
    order = torch.sort(key, stable=True).indices
    counts = _counts(key, n_experts + 1)
    first = torch.cumsum(counts, dim=0) - counts
    slot = torch.empty_like(flat_e)
    slot[order] = (torch.arange(key.numel(), device=key.device)
                   - first[key[order]])
    slot = torch.where(send, slot, 0)
    return flat_e, slot, send, send & (slot < cap)


def _pack(x, idx, gates, n_experts, cap, mirrored_mask):
    """Sender-side combining: scatter local tokens into a per-expert buffer.

    x: (T, D); idx/gates: (T, k). Returns:
      buf       (E, C, D) combined send buffer
      buf_gate  (E, C)    gate weight per slot
      buf_tok   (E, C)    source token index (-1: empty)
    Tokens whose expert is mirrored (``mirrored_mask`` (E,) bool) are
    excluded: they never become network messages.  Each kept pair is
    written to its (expert, slot), which receives no other; every other
    pair goes to one dump row past the buffer's end, which is cut off (the
    reference's scatter), so that every shape is static."""
    T, D = x.shape
    k = idx.shape[1]
    flat_e, slot, _, keep = _slots(idx, n_experts, cap, mirrored_mask)
    rows = n_experts * cap
    dest = torch.where(keep, flat_e * cap + slot, rows)
    tok = torch.div(torch.arange(T * k, device=x.device), k,
                    rounding_mode="floor")
    buf = x.new_zeros(rows + 1, D).index_copy_(0, dest, x[tok])[:rows]
    buf_gate = gates.new_zeros(rows + 1).index_copy_(
        0, dest, gates.reshape(-1))[:rows]
    buf_tok = torch.full((rows + 1,), -1, dtype=torch.int32,
                         device=x.device).index_copy_(0, dest,
                                                      tok.int())[:rows]
    return (buf.view(n_experts, cap, D), buf_gate.view(n_experts, cap),
            buf_tok.view(n_experts, cap))


def _unpack(y_buf, buf_gate, buf_tok, T, D):
    """Combine expert outputs back per source token (receiver-side
    combine): out[tok] += y * gate over the occupied slots; the empty
    slots add into a dump row past the end, which is cut off (the
    reference's scatter: static shapes)."""
    flat_y = y_buf.reshape(-1, D) * buf_gate.reshape(-1)[:, None]
    flat_t = buf_tok.reshape(-1).long()
    tgt = torch.where(flat_t >= 0, flat_t, T)
    return y_buf.new_zeros(T + 1, D).index_add_(0, tgt, flat_y)[:T]


def _record(idx, n_experts, cap, mirrored_mask, buf_tok, aux):
    if record is None:
        return
    _, _, send, keep = _slots(idx, n_experts, cap, mirrored_mask)
    flat_e = idx.reshape(-1).long()
    record.append({
        "tokens": idx.shape[0], "pairs": flat_e.numel(), "cap": cap,
        "rows": buf_tok.numel(),
        "load": _counts(flat_e, n_experts),
        "kept": _counts(torch.where(keep, flat_e, n_experts),
                        n_experts + 1)[:n_experts],
        "sent": send.sum(), "occupied": (buf_tok >= 0).sum(),
        "aux": aux.detach()})


def moe_ffn_ref(x: torch.Tensor, w: dict, cfg: MoEConfig) -> tuple:
    """Reference single-worker dispatch. x: (T, D). w holds router (D, E),
    w_gate / w_up (E, D, F), w_down (E, F, D).  Returns (y, aux)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * T * k / E))
    gates, idx, probs = router_probs(x, w["router"], k)
    mirrored = torch.zeros(E, dtype=torch.bool, device=x.device)
    buf, bg, bt = _pack(x, idx, gates, E, cap, mirrored)
    y_buf = _expert_mlp(buf, w["w_gate"], w["w_up"], w["w_down"])
    y = _unpack(y_buf, bg, bt, T, D)
    aux = load_balance_loss(probs, idx, E)
    _record(idx, E, cap, mirrored, bt, aux)
    return y, aux


def moe_ffn_ep(x: torch.Tensor, w: dict, cfg: MoEConfig,
               ctx: MoEContext) -> tuple:
    """Expert-parallel dispatch on one rank of ``ctx``.

    x: (T_loc, D), this rank's slice of the tokens; w: the expert stacks,
    of which the rank runs its EP group's shard ``[e * E/ep, (e+1) *
    E/ep)``: the whole stacks (E, ...), whose rows it reads, or that
    shard alone (E/ep, ...: stored expert shards), by their shape; and
    the mirrored copies w*_m (n_m, ...).
    Route -> pack per-(rank, expert) combined buffers -> all_to_all over
    the EP group -> local experts -> all_to_all back -> combine.  The
    mirrored experts 0..n_m-1 short-circuit the network: each rank runs
    them dense-gated over all its tokens.  ``cap`` is computed from T_loc,
    as each reference rank does.  Returns (y_loc, aux averaged over the
    default group's ranks)."""
    group = ctx.ep_group
    E, k = cfg.n_experts, cfg.top_k
    ep_size = dist.get_world_size(group)
    if E % ep_size:
        raise ValueError(f"{E} experts do not shard over {ep_size} EP ranks")
    e_loc = E // ep_size
    lo = dist.get_rank(group) * e_loc
    n_m = min(cfg.n_mirrored_experts, E)
    T_loc, D = x.shape
    cap = max(1, int(cfg.capacity_factor * T_loc * k / E))
    gates, idx, probs = router_probs(x, w["router"], k)
    mirrored = torch.arange(E, device=x.device) < n_m   # hottest first
    buf, bg, bt = _pack(x, idx, gates, E, cap, mirrored)
    # ---- network path: one combined message per (dst rank, expert) ----
    recv = coll.all_to_all(buf, group)
    # recv: (ep_size senders * e_loc, cap, D) -> per local expert
    recv = recv.view(ep_size, e_loc, cap, D).transpose(0, 1).reshape(
        e_loc, ep_size * cap, D)
    stacks = [w[k] for k in ("w_gate", "w_up", "w_down")]
    if stacks[0].shape[0] == E:
        stacks = [t[lo:lo + e_loc] for t in stacks]
    elif stacks[0].shape[0] != e_loc:
        raise ValueError(f"expert stacks of {stacks[0].shape[0]} rows: "
                         f"neither all {E} experts nor this rank's {e_loc}")
    y = _expert_mlp(recv, *stacks)
    y = y.view(e_loc, ep_size, cap, D).transpose(0, 1).contiguous()
    back = coll.all_to_all(y, group)
    out = _unpack(back.view(E, cap, D), bg, bt, T_loc, D)
    # ---- mirrored path: local compute, zero messages ----
    for j in range(n_m):
        g = ((idx == j) * gates).sum(-1)
        out = out + _expert_mlp(x, w["w_gate_m"][j], w["w_up_m"][j],
                                w["w_down_m"][j]) * g[:, None]
    aux = load_balance_loss(probs, idx, E)
    _record(idx, E, cap, mirrored, bt, aux)
    aux = coll.psum_replicated(aux.reshape(1), dist.group.WORLD)
    return out, aux[0] / dist.get_world_size()
