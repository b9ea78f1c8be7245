"""The paper's message channels on torch tensors (the counterpart of
``repro.core.channels`` on one device).

Everything operates on tensors with a leading worker axis ``M``; on one
device that axis is a batch dimension (exact M-worker simulation).  Every
channel returns a ``stats`` dict with the *paper's* message metric,
computed exactly (int64 tensors; compare them by value):

  msgs_basic     — Pregel vertex-to-vertex messages (network only)
  msgs_combined  — after sender-side combining (distinct (src worker, dst
                   vertex) pairs) — Ch_msg with combiner
  msgs_mirror    — Ch_mir: one message per (active mirrored vertex, remote
                   worker hosting a mirror)  [Theorem 1]
  msgs_rr        — Ch_req (request-respond): 2 * distinct (worker, remote
                   target) pairs  [Theorem 3]
  per_worker_*   — (M,) sent-message counts for the balance reports

Payloads are scalar per lane, ``(M, n_loc)``, or feature-blocked with one
trailing feature axis, ``(M, n_loc, F)`` (gSpMM, GCN).  Activity and so the
message accounting are per lane: a vector join sends one (F,) block per
active lane, and its stats equal the scalar broadcast's.  On the pallas
backend a feature-blocked join never holds an (E, F) per-edge array: the
channels hand the plans an ``EdgeMap`` that composes the source gather,
the relay and the masks, and the plan computes one row chunk at a time.
``count=False`` skips the accounting (the gSpMM joins inside training,
whose stats the reference drops).

The pg-level entry points (``broadcast``, ``gather``, ``gather_edges``,
``scatter_state``, ``scatter_edges``) also take one rank's
``exec.ShardedGraph``; they then route to the sharded implementations of
``core/exec.py``, whose stats are that rank's part of the totals.

Spans (``repro_torch.tracing``): each pg-level entry point is the loop
span ``channels.<name>``, ``push_mirror`` is ``channels.mirror``, and the
message accounting alone is ``channels.count``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import plan as planlib
from repro_torch.core.plan import (EdgeMap, Payload, feat_mask, feat_shape,
                                   identity_of, per_worker, scatter_hits,
                                   scatter_op)
from repro_torch.graph.structs import PartitionedGraph

BACKENDS = ("dense", "pallas")
RELAYS = ("none", "add_w", "mul_w")
_COMBINE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def relay_values(src_val: torch.Tensor, ew: torch.Tensor, relay: str
                 ) -> torch.Tensor:
    """Fold the per-edge field into the transported value: the paper's
    relay() hook.  ``add_w`` adds the edge weight (SSSP); ``mul_w``
    multiplies by it (weighted gSpMM: ``u_mul_e``).  The edge weight
    broadcasts over a trailing feature axis of ``src_val``."""
    if relay == "none":
        return src_val
    if relay not in RELAYS:
        raise ValueError(f"unknown relay {relay!r}; use one of {RELAYS}")
    w = ew if src_val.dim() == ew.dim() else ew[..., None]
    return src_val + w if relay == "add_w" else src_val * w


def _edge_map(rows: torch.Tensor, index: torch.Tensor, ew: torch.Tensor,
              relay: str) -> EdgeMap:
    """Feature-blocked per-edge payloads ``relay(rows[index[e]], ew[e])``
    of the flat edges ``e``, described for the plan combine (``rows``
    (N, F); ``index``, ``ew`` (E,))."""
    return EdgeMap(lambda e: relay_values(rows[index[e]], ew[e], relay),
                   index.shape[0], rows.shape[1], rows.dtype, rows.device)



def _sharded(pg) -> bool:
    """True when ``pg`` is one rank's ``exec.ShardedGraph``: the pg-level
    channels then route to the sharded implementations."""
    return getattr(pg, "sharded", False)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")


def _reduce_op(op: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    if op == "min":
        return x.amin(dim=dim)
    if op == "max":
        return x.amax(dim=dim)
    # in the payload's dtype: torch would widen an int32 sum to int64
    return x.sum(dim=dim, dtype=x.dtype)


def _flat_worker(pg: PartitionedGraph, kind: str):
    """(per-edge worker ids, shard->logical map | None) for one flat csr
    edge set.  Under a split partition the ids are *physical shard* ids;
    the map folds them back to logical workers."""
    if pg.phys_log is not None:
        return getattr(pg, f"{kind}_pw"), pg.phys_log
    src = pg.eg_src if kind == "eg" else pg.all_src
    return torch.div(src, pg.n_loc, rounding_mode="floor"), None


def _dense_combine(idx: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                   op: str, M_src: int, M: int, n_loc: int,
                   row_log: torch.Tensor, count: bool = True):
    """The dense reference combine: one (M_src, n_pad[, F]) per-source
    partial built by a flat scatter at ``idx = src_row * n_pad + target``
    (the per-source combiner), its mask-driven cross-pair count, and the
    worker-axis transpose (the all-to-all) reduced at the receiver."""
    n_pad = M * n_loc
    feat = feat_shape(v, 1)
    ident = identity_of(op, v.dtype)
    partial = torch.full((M_src * n_pad,) + feat, ident, dtype=v.dtype,
                         device=v.device)
    partial3 = scatter_op(op, partial, idx, v).view((M_src, M, n_loc)
                                                     + feat)
    inbox = _reduce_op(op, partial3.transpose(0, 1), dim=1)
    if not count:
        return inbox, None, None
    sent = scatter_hits(M_src * n_pad, idx, mask).view(M_src, M, n_loc)
    dst_w = torch.arange(M, device=v.device)
    cross3 = sent & (dst_w[None, :, None] != row_log[:, None, None])
    return inbox, cross3.sum(), per_worker(row_log, cross3.sum(dim=(1, 2)),
                                           M)


def _stats(msgs, pw, base, count: bool) -> Dict[str, torch.Tensor]:
    if not count:
        return {}
    stats = {"msgs_combined": msgs, "per_worker_combined": pw}
    stats.update(base)
    return stats


def push_combined(targets: torch.Tensor, values: Payload,
                  mask: torch.Tensor, op: str, M: int, n_loc: int,
                  backend: str = "dense",
                  plan: Optional[planlib.EdgePlan] = None,
                  count: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """targets: (M, K) global dst ids; values: (M, K), (M, K, F) or an
    ``EdgeMap`` of the M*K flat edges; mask: (M, K).

    Returns (inbox (M, n_loc[, F]) combined with ``op``, stats).
    backend="dense": the per-source partial buffer is the paper's combiner
    (O(M * n_pad) memory).  backend="pallas": the combine runs
    destination-blocked through the segment_combine kernels with a
    precomputed ``plan`` (static targets), or through the sorted segmented
    combine without one.  Inboxes and stats are the same either way."""
    _check_backend(backend)
    device = mask.device
    ident = identity_of(op, values.dtype)
    own = torch.arange(M, device=device)
    base = {}
    if count:
        with tracing.span("channels.count"):
            raw_cross = mask & (torch.div(targets, n_loc,
                                          rounding_mode="floor")
                                != own[:, None])
            base = {"msgs_basic": raw_cross.sum(),
                    "per_worker_basic": raw_cross.sum(dim=1)}

    if isinstance(values, EdgeMap) and (backend == "dense" or plan is None):
        values = values.materialize().view(targets.shape + (values.feat,))
    if isinstance(values, torch.Tensor):
        feat = feat_shape(values, 2)
    if backend == "pallas" and plan is not None:
        # the plan encodes the static edge mask; the runtime mask is folded
        # in as identity values for the combine and passed as-is for the
        # accounting
        if isinstance(values, EdgeMap):
            masked = values.where(mask.reshape(-1), ident)
        else:
            masked = torch.where(feat_mask(mask, values, 2), values, ident)
            masked = masked.reshape((-1,) + feat)
        inbox, cnt = planlib.combine_with_plan(
            plan, masked, op, count_cross=count,
            flat_hits=mask.reshape(-1) if count else None)
        msgs, pw = cnt if count else (None, None)
    elif backend == "pallas":
        inbox, (msgs, pw) = planlib.combine_sorted(
            targets, values, mask, op, M, n_loc)
    else:
        n_pad = M * n_loc
        idx = (own[:, None] * n_pad
               + torch.where(mask, targets, 0).long()).reshape(-1)
        v = torch.where(feat_mask(mask, values, 2), values, ident)
        inbox, msgs, pw = _dense_combine(
            idx, v.reshape((-1,) + feat), mask.reshape(-1), op, M, M, n_loc,
            own, count)
    return inbox, _stats(msgs, pw, base, count)


def push_combined_flat(targets: torch.Tensor, values: Payload,
                       mask: torch.Tensor, src_worker: torch.Tensor,
                       op: str, M: int, n_loc: int,
                       backend: str = "dense",
                       plan: Optional[planlib.EdgePlan] = None,
                       log_of: Optional[np.ndarray] = None,
                       count: bool = True
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CSR-layout twin of ``push_combined``: flat (E,) per-edge arrays with
    explicit per-edge source workers; ``values`` is (E,), (E, F) or an
    ``EdgeMap`` of the E edges.  Under a split partition ``src_worker``
    holds physical shard ids and ``log_of`` ((M_src,) shard -> logical
    map) keeps crossness and the (M,) ``per_worker_*`` report logical."""
    _check_backend(backend)
    device = mask.device
    ident = identity_of(op, values.dtype)
    src_worker = src_worker.long()
    log_t = (None if log_of is None
             else torch.as_tensor(np.asarray(log_of), device=device).long())
    wlog = src_worker if log_t is None else log_t[src_worker]
    base = {}
    if count:
        with tracing.span("channels.count"):
            cross = mask & (torch.div(targets, n_loc, rounding_mode="floor")
                            != wlog)
            base = {"msgs_basic": cross.sum(),
                    "per_worker_basic": per_worker(wlog, cross, M)}

    if isinstance(values, EdgeMap) and (backend == "dense" or plan is None):
        values = values.materialize()
    if isinstance(values, torch.Tensor):
        feat_shape(values, 1)
    if backend == "pallas" and plan is not None:
        if isinstance(values, EdgeMap):
            masked = values.where(mask, ident)
        else:
            masked = torch.where(feat_mask(mask, values, 1), values, ident)
        inbox, cnt = planlib.combine_with_plan(
            plan, masked, op, count_cross=count, log_of=log_of, M_out=M,
            flat_hits=mask if count else None)
        msgs, pw = cnt if count else (None, None)
    elif backend == "pallas":
        inbox, (msgs, pw) = planlib.combine_sorted_flat(
            targets, values, mask, src_worker, op, M, n_loc,
            log_of=log_of)
    else:
        n_pad = M * n_loc
        M_src = M if log_t is None else len(log_t)
        row_log = torch.arange(M, device=device) if log_t is None else log_t
        idx = src_worker * n_pad + torch.where(mask, targets, 0).long()
        v = torch.where(feat_mask(mask, values, 1), values, ident)
        inbox, msgs, pw = _dense_combine(
            idx, v, mask, op, M_src, M, n_loc, row_log, count)
    return inbox, _stats(msgs, pw, base, count)


@tracing.traced("channels.mirror")
def push_mirror(pg: PartitionedGraph, vals: torch.Tensor,
                active: torch.Tensor, op: str, relay: str = "none",
                backend: str = "dense", count: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Broadcast each active mirrored vertex's value to its mirrors, fan out
    locally.  vals: (M, n_loc) or feature-blocked (M, n_loc, F); active:
    (M, n_loc).  relay='add_w' adds the edge weight at the mirror (the
    paper's relay() for SSSP); relay='mul_w' multiplies by it (weighted
    gSpMM aggregation)."""
    _check_backend(backend)
    ident = identity_of(op, vals.dtype)
    n_pad = pg.n_pad
    feat = feat_shape(vals, 2)
    flat_vals = vals.reshape((-1,) + feat)
    flat_act = active.reshape(-1)
    # mir_ids pads with n_pad: clamp before reading (an index past the end
    # would fault on the card) and mask the padding out
    safe = pg.mir_ids.long().clamp(0, n_pad - 1)
    valid = pg.mir_ids < n_pad
    mir_act = valid & flat_act[safe]
    mir_vals = torch.where(feat_mask(mir_act, flat_vals, 1), flat_vals[safe],
                           ident)
    # ^ one value per mirrored vertex: the all-gather payload (Ch_mir send)

    if feat:
        # vector payloads carry the per-lane activity flag explicitly (a
        # feature-wise value == identity test would mask real features)
        esrc = pg.mir_esrc.long().reshape(-1)
        ev = _edge_map(mir_vals, esrc, pg.mir_ew.reshape(-1), relay).where(
            (pg.mir_emask.reshape(-1) & mir_act[esrc]), ident)
        if backend == "dense":
            ev = ev.materialize()
    else:
        raw = mir_vals[pg.mir_esrc.long()]
        ev = relay_values(raw, pg.mir_ew, relay)
        ev = torch.where(pg.mir_emask & (raw != ident), ev, ident).reshape(-1)
    if backend == "pallas":
        inbox, _ = planlib.combine_with_plan(
            planlib.get_plan(pg, "mir"), ev, op, count_cross=False)
    else:
        if pg.layout == "csr":
            # mir_edst is global in csr: per-worker fan-out buffers are
            # disjoint slices of one flat (n_pad,) scatter
            idx = pg.mir_edst.long()
        else:
            row = torch.arange(pg.M, device=vals.device)[:, None]
            idx = (row * pg.n_loc
                   + torch.where(pg.mir_emask, pg.mir_edst, 0)).reshape(-1)
        buf = torch.full((n_pad,) + feat, ident, dtype=vals.dtype,
                         device=vals.device)
        inbox = scatter_op(op, buf, idx, ev).view((pg.M, pg.n_loc) + feat)
    if not count:
        return inbox, {}
    # mask-driven accounting: an ACTIVE mirrored vertex is broadcast to its
    # hosting workers whatever its value (even one equal to the identity)
    with tracing.span("channels.count"):
        sent = torch.where(mir_act, pg.mir_nworkers.long(), 0)
        owner_w = torch.div(safe, pg.n_loc, rounding_mode="floor").clamp(
            0, pg.M - 1)
        stats = {"msgs_mirror": sent.sum(),
                 "per_worker_mirror": per_worker(owner_w, sent, pg.M)}
    return inbox, stats


@tracing.traced("channels.broadcast")
def broadcast(pg: PartitionedGraph, vals: torch.Tensor,
              active: torch.Tensor, op: str, relay: str = "none",
              use_mirroring: bool = True, backend: str = "dense",
              count: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full paper pipeline: low-degree vertices push through Ch_msg with
    combining; high-degree (>= pg.tau) vertices through Ch_mir.  ``vals``
    is each vertex's broadcast value, (M, n_loc) or feature-blocked
    (M, n_loc, F); relay folds edge fields.  use_mirroring=False routes
    EVERY edge through Ch_msg (Pregel-noM).  backend="pallas" drives both
    channels through the precomputed message plans and the segment_combine
    kernels; inboxes and stats are unchanged.  ``pg.layout`` picks the edge
    representation; results and stats are layout-invariant.
    ``count=False`` returns no stats."""
    _check_backend(backend)
    if _sharded(pg):
        from repro_torch.core import exec as exec_mod
        return exec_mod.broadcast_sharded(pg, vals, active, op, relay,
                                          use_mirroring, backend, count)
    kind = "eg" if use_mirroring else "all"
    esrc = getattr(pg, f"{kind}_src").long()
    edst = getattr(pg, f"{kind}_dst")
    emask = getattr(pg, f"{kind}_mask")
    ew = getattr(pg, f"{kind}_w")
    feat = feat_shape(vals, 2)
    plan = planlib.get_plan(pg, kind) if backend == "pallas" else None
    if pg.layout == "csr":
        if feat:
            v = _edge_map(vals.reshape(-1, feat[0]), esrc, ew, relay)
        else:
            src_val = vals.reshape(-1)[esrc]     # esrc is global in csr
            v = relay_values(src_val, ew, relay)
        src_act = active.reshape(-1)[esrc]
        worker, log_of = _flat_worker(pg, kind)
        inbox, stats = push_combined_flat(edst, v, emask & src_act,
                                          worker, op, pg.M, pg.n_loc,
                                          backend=backend, plan=plan,
                                          log_of=log_of, count=count)
    else:
        if feat:
            row = torch.arange(pg.M, device=vals.device)[:, None]
            v = _edge_map(vals.reshape(-1, feat[0]),
                          (row * pg.n_loc + esrc).reshape(-1),
                          ew.reshape(-1), relay)
        else:
            src_val = torch.gather(vals, 1, esrc)
            v = relay_values(src_val, ew, relay)
        src_act = torch.gather(active, 1, esrc)
        inbox, stats = push_combined(edst, v, emask & src_act, op,
                                     pg.M, pg.n_loc, backend=backend,
                                     plan=plan, count=count)
    if use_mirroring:
        inbox2, s2 = push_mirror(pg, vals, active, op, relay,
                                 backend=backend, count=count)
        inbox = _COMBINE[op](inbox, inbox2)
        stats.update(s2)
    elif count:
        stats["msgs_mirror"] = torch.zeros((), dtype=torch.int64,
                                           device=vals.device)
        stats["per_worker_mirror"] = torch.zeros(pg.M, dtype=torch.int64,
                                                 device=vals.device)
    if count:
        stats["msgs_total"] = stats["msgs_combined"] + stats["msgs_mirror"]
        stats["per_worker_total"] = (stats["per_worker_combined"]
                                     + stats["per_worker_mirror"])
    return inbox, stats


# ---------------------------------------------------------------------------
# Ch_req: request-respond distributed gather  (paper §6)
# ---------------------------------------------------------------------------

def _dedup_row(t: torch.Tensor, sentinel: int):
    """Sort-based dedup of request lists along the last axis: one worker's
    (R,) list, or (M, R) rows at once.  ``uniq`` holds each row's distinct
    targets below ``sentinel`` in ascending order, padded with
    ``sentinel``; ``inv`` (int32) is each request's index into its row's
    ``uniq``.  A row whose requests all equal ``sentinel`` (every request
    masked) has ``inv == -1`` throughout, as in the reference, where a
    read at -1 wraps: callers clamp before they index."""
    R = t.shape[-1]
    s, order = torch.sort(t, dim=-1, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    first &= s < sentinel
    rank = torch.cumsum(first, dim=-1) - 1
    uniq = torch.full_like(t, -1).scatter_reduce_(
        -1, torch.where(first, rank, R - 1), torch.where(first, s, -1),
        "amax")
    uniq = torch.where(uniq < 0, sentinel, uniq)
    inv = torch.empty_like(rank).scatter_(-1, order, rank)
    return uniq, inv.to(torch.int32)


def rr_gather(vals: torch.Tensor, targets: torch.Tensor,
              tmask: torch.Tensor, M: int, n_loc: int, dedup: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Distributed gather: each worker reads vals[target] for arbitrary
    global targets (the paper's request(u) / get_resp(u)).

    vals: (M, n_loc) or feature-blocked (M, n_loc, F); targets/tmask:
    (M, R).  Returns (out (M, R[, F]), stats).  dedup=True is the
    request-respond channel (one request per distinct target per worker,
    Theorem 3); dedup=False sends every request on its own (Pregel basic:
    msgs_rr degenerates to msgs_basic), same gathered values either way.

    On one device the exchange is a permutation: each worker's distinct
    targets (its requests) are read at their owners (the responses) and
    carried back to the requests through ``inv``.  The reference also lays
    the requests out in per-owner buckets, (M, M, R) of them, which
    changes neither the values nor the stats, so the port skips it.
    """
    n_pad = M * n_loc
    R = targets.shape[1]
    feat = feat_shape(vals, 2)
    device = vals.device
    own = torch.arange(M, device=device)[:, None]
    t = torch.where(tmask, targets, n_pad)
    if dedup:
        uniq, inv = _dedup_row(t, n_pad)
    else:
        uniq = t
        inv = torch.arange(R, device=device).expand(M, R)
    owner = torch.div(uniq, n_loc, rounding_mode="floor").clamp(0, M - 1)
    uvalid = uniq < n_pad

    # the owners' responses, one a distinct request; a negative target has
    # no slot at its (clipped) owner and reads 0, as in the reference
    flat = vals.reshape((-1,) + feat)
    resp = flat[uniq.long().clamp(0, n_pad - 1)]
    resp = torch.where(feat_mask(uvalid & (uniq >= 0), resp, 2), resp, 0)
    # back to the requests; a row with no valid request has inv == -1
    back = inv.long().clamp(min=0)
    out = torch.gather(resp, 1, feat_mask(back, resp, 2).expand(
        (M, R) + feat))
    out = torch.where(feat_mask(tmask, out, 2), out, 0)

    with tracing.span("channels.count"):
        remote_u = uvalid & (owner != own)
        tw = torch.div(targets, n_loc, rounding_mode="floor")
        raw_remote = tmask & (tw != own)
        stats = {
            "msgs_rr": 2 * remote_u.sum(),
            "msgs_basic": 2 * raw_remote.sum(),
            "per_worker_rr": remote_u.sum(dim=1) + per_worker(
                owner.reshape(-1), remote_u.reshape(-1), M),
            "per_worker_basic": raw_remote.sum(dim=1) + per_worker(
                tw.clamp(0, M - 1).reshape(-1), raw_remote.reshape(-1), M),
        }
    return out, stats


def rr_gather_flat(vals: torch.Tensor, targets: torch.Tensor,
                   worker: torch.Tensor, tmask: torch.Tensor,
                   M: int, n_loc: int, dedup: bool = True,
                   log_of: Optional[np.ndarray] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CSR-layout twin of ``rr_gather``: flat (E,) targets with explicit
    (E,) requesting-worker ids (ragged per-worker request counts).

    The gathered values are a direct read; the stats reproduce the padded
    channel's accounting exactly: msgs_rr counts 2 messages per distinct
    remote (worker, target) pair (Theorem 3), per_worker_* charge both the
    requester and the owner, msgs_basic counts every raw remote request.
    Under a split partition ``worker`` holds physical shard ids (each
    shard deduplicates its own request list) and ``log_of`` maps them back
    to logical workers for the remote test and the per-worker charges.
    """
    n_pad = M * n_loc
    feat = feat_shape(vals, 2)
    device = vals.device
    t = torch.where(tmask, targets, n_pad)
    got = vals.reshape((-1,) + feat)[t.long().clamp(0, n_pad - 1)]
    out = torch.where(feat_mask(tmask, got, 1), got, 0)
    if targets.shape[0] == 0:
        zero = torch.zeros((), dtype=torch.int64, device=device)
        zero_m = torch.zeros(M, dtype=torch.int64, device=device)
        return out, {"msgs_rr": zero, "msgs_basic": zero.clone(),
                     "per_worker_rr": zero_m, "per_worker_basic":
                     zero_m.clone()}

    worker = worker.long()
    log_t = (None if log_of is None
             else torch.as_tensor(np.asarray(log_of), device=device).long())
    wlog = worker if log_t is None else log_t[worker]
    tw = torch.div(targets, n_loc, rounding_mode="floor")
    owner = tw.clamp(0, M - 1)
    raw_remote = tmask & (tw != wlog)
    with tracing.span("channels.count"):
        if dedup:
            # distinct (worker, target) = segment heads of the shared sort
            _, ws, ts, first = planlib.sort_by_worker_target(worker, t)
            ws_log = ws if log_t is None else log_t[ws]
            ts_w = torch.div(ts, n_loc, rounding_mode="floor")
            remote_u = first & (ts < n_pad) & (ts_w != ws_log)
            u_w, u_owner = ws_log, ts_w.clamp(0, M - 1)
        else:
            remote_u, u_w, u_owner = raw_remote, wlog, owner
        stats = {
            "msgs_rr": 2 * remote_u.sum(),
            "msgs_basic": 2 * raw_remote.sum(),
            "per_worker_rr": (per_worker(u_w, remote_u, M)
                              + per_worker(u_owner, remote_u, M)),
            "per_worker_basic": (per_worker(wlog, raw_remote, M)
                                 + per_worker(owner, raw_remote, M)),
        }
    return out, stats


def scatter_combine(vals: torch.Tensor, targets: torch.Tensor,
                    upd: torch.Tensor, mask: torch.Tensor, op: str,
                    M: int, n_loc: int, backend: str = "dense"):
    """Distributed scatter-``op`` into vals (S-V hooking writes).  Messages
    are counted like the combined channel (one per distinct (worker,
    target) after sender-side combining).  Targets are runtime state, so
    backend="pallas" uses the sorted segmented combine (no precomputed
    plan is possible): same stats, O(n_pad) instead of O(M * n_pad)."""
    inbox, stats = push_combined(targets, upd, mask, op, M, n_loc,
                                 backend=backend)
    return _COMBINE[op](vals, inbox), stats


def scatter_combine_flat(vals: torch.Tensor, targets: torch.Tensor,
                         upd: torch.Tensor, mask: torch.Tensor,
                         worker: torch.Tensor, op: str,
                         M: int, n_loc: int, backend: str = "dense",
                         log_of: Optional[np.ndarray] = None):
    """CSR twin of ``scatter_combine``: flat (E,) edge-shaped writes with
    explicit per-edge source workers (MSF min-edge election)."""
    inbox, stats = push_combined_flat(targets, upd, mask, worker, op,
                                      M, n_loc, backend=backend,
                                      log_of=log_of)
    return _COMBINE[op](vals, inbox), stats


# ---------------------------------------------------------------------------
# pg-level wrappers: layout-dispatching channel entry points
# ---------------------------------------------------------------------------

@tracing.traced("channels.gather")
def gather(pg: PartitionedGraph, vals: torch.Tensor, targets: torch.Tensor,
           tmask: torch.Tensor, dedup: bool = True
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Distributed pointer read ``vals[target]`` for state-shaped target
    rows (S-V / MSF pointer chasing)."""
    if _sharded(pg):
        from repro_torch.core import exec as exec_mod
        return exec_mod.gather_sharded(pg, vals, targets, tmask, dedup)
    return rr_gather(vals, targets, tmask, pg.M, pg.n_loc, dedup)


@tracing.traced("channels.gather_edges")
def gather_edges(pg: PartitionedGraph, vals: torch.Tensor,
                 targets: torch.Tensor, tmask: torch.Tensor,
                 dedup: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Distributed gather for edge-shaped targets aligned with the ``all``
    adjacency (attribute broadcast, MSF neighbour reads): padded rows go
    through ``rr_gather``, flat csr through ``rr_gather_flat`` with the
    per-edge source worker of ``pg.all_src``."""
    if _sharded(pg):
        from repro_torch.core import exec as exec_mod
        return exec_mod.gather_edges_sharded(pg, vals, targets, tmask, dedup)
    if pg.layout == "csr":
        worker, log_of = _flat_worker(pg, "all")
        return rr_gather_flat(vals, targets, worker, tmask, pg.M, pg.n_loc,
                              dedup, log_of=log_of)
    return rr_gather(vals, targets, tmask, pg.M, pg.n_loc, dedup)


@tracing.traced("channels.scatter_state")
def scatter_state(pg: PartitionedGraph, base: torch.Tensor,
                  targets: torch.Tensor, upd: torch.Tensor,
                  mask: torch.Tensor, op: str, backend: str = "dense"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Distributed scatter-``op`` for state-shaped runtime targets (S-V
    hooking writes)."""
    if _sharded(pg):
        from repro_torch.core import exec as exec_mod
        return exec_mod.scatter_state_sharded(pg, base, targets, upd, mask,
                                              op, backend)
    return scatter_combine(base, targets, upd, mask, op, pg.M, pg.n_loc,
                           backend=backend)


@tracing.traced("channels.scatter_edges")
def scatter_edges(pg: PartitionedGraph, base: torch.Tensor,
                  targets: torch.Tensor, upd: torch.Tensor,
                  mask: torch.Tensor, op: str, backend: str = "dense"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Distributed scatter-``op`` for edge-shaped runtime values aligned
    with the ``all`` adjacency (MSF min-edge election)."""
    if _sharded(pg):
        from repro_torch.core import exec as exec_mod
        return exec_mod.scatter_edges_sharded(pg, base, targets, upd, mask,
                                              op, backend)
    if pg.layout == "csr":
        worker, log_of = _flat_worker(pg, "all")
        return scatter_combine_flat(base, targets, upd, mask, worker, op,
                                    pg.M, pg.n_loc, backend=backend,
                                    log_of=log_of)
    return scatter_combine(base, targets, upd, mask, op, pg.M, pg.n_loc,
                           backend=backend)
