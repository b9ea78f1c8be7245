"""The paper's broadcast channels on torch tensors (the counterpart of the
broadcast half of ``repro.core.channels``; Ch_req comes with a later slice).

Everything operates on tensors with a leading worker axis ``M``; on one
device that axis is a batch dimension (exact M-worker simulation).  Every
channel returns a ``stats`` dict with the *paper's* message metric,
computed exactly (int64 tensors; compare them by value):

  msgs_basic     — Pregel vertex-to-vertex messages (network only)
  msgs_combined  — after sender-side combining (distinct (src worker, dst
                   vertex) pairs) — Ch_msg with combiner
  msgs_mirror    — Ch_mir: one message per (active mirrored vertex, remote
                   worker hosting a mirror)  [Theorem 1]
  per_worker_*   — (M,) sent-message counts for the balance reports

Payloads are scalar per lane in this slice; feature-blocked payloads come
with the vector kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.core.plan import (identity_of, per_worker, scatter_hits,
                                   scatter_op)
from repro_torch.graph.structs import PartitionedGraph

BACKENDS = ("dense", "pallas")
RELAYS = ("none", "add_w", "mul_w")
_COMBINE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def relay_values(src_val: torch.Tensor, ew: torch.Tensor, relay: str
                 ) -> torch.Tensor:
    """Fold the per-edge field into the transported value: the paper's
    relay() hook.  ``add_w`` adds the edge weight (SSSP); ``mul_w``
    multiplies by it."""
    if relay == "none":
        return src_val
    if relay not in RELAYS:
        raise ValueError(f"unknown relay {relay!r}; use one of {RELAYS}")
    return src_val + ew if relay == "add_w" else src_val * ew


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{BACKENDS}")


def _reduce_op(op: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    if op == "min":
        return x.amin(dim=dim)
    if op == "max":
        return x.amax(dim=dim)
    return x.sum(dim=dim)


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
                   row_log: torch.Tensor):
    """The dense reference combine: one (M_src, n_pad) per-source partial
    built by a flat scatter at ``idx = src_row * n_pad + target`` (the
    per-source combiner), its mask-driven cross-pair count, and the
    worker-axis transpose (the all-to-all) reduced at the receiver."""
    n_pad = M * n_loc
    ident = identity_of(op, v.dtype)
    partial = torch.full((M_src * n_pad,), ident, dtype=v.dtype,
                         device=v.device)
    partial3 = scatter_op(op, partial, idx, v).view(M_src, M, n_loc)
    sent = scatter_hits(M_src * n_pad, idx, mask).view(M_src, M, n_loc)
    dst_w = torch.arange(M, device=v.device)
    cross3 = sent & (dst_w[None, :, None] != row_log[:, None, None])
    inbox = _reduce_op(op, partial3.transpose(0, 1), dim=1)
    return inbox, cross3.sum(), per_worker(row_log, cross3.sum(dim=(1, 2)),
                                           M)


def push_combined(targets: torch.Tensor, values: torch.Tensor,
                  mask: torch.Tensor, op: str, M: int, n_loc: int,
                  backend: str = "dense",
                  plan: Optional[planlib.EdgePlan] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """targets: (M, K) global dst ids; values: (M, K); mask: (M, K).

    Returns (inbox (M, n_loc) combined with ``op``, stats).
    backend="dense": the per-source partial buffer is the paper's combiner
    (O(M * n_pad) memory).  backend="pallas": the combine runs
    destination-blocked through the segment_combine kernel with a
    precomputed ``plan`` (static targets), or through the sorted segmented
    combine without one.  Inboxes and stats are the same either way."""
    _check_backend(backend)
    planlib._scalar_only(values, 2)
    device = values.device
    own = torch.arange(M, device=device)
    raw_cross = mask & (torch.div(targets, n_loc, rounding_mode="floor")
                        != own[:, None])
    base = {"msgs_basic": raw_cross.sum(),
            "per_worker_basic": raw_cross.sum(dim=1)}

    if backend == "pallas":
        if plan is not None:
            # the plan encodes the static edge mask; the runtime mask is
            # folded in as identity values for the combine and passed
            # as-is for the accounting
            masked = torch.where(mask, values, identity_of(op, values.dtype))
            inbox, (msgs, pw) = planlib.combine_with_plan(
                plan, masked.reshape(-1), op, count_cross=True,
                flat_hits=mask.reshape(-1))
        else:
            inbox, (msgs, pw) = planlib.combine_sorted(
                targets, values, mask, op, M, n_loc)
    else:
        n_pad = M * n_loc
        idx = (own[:, None] * n_pad
               + torch.where(mask, targets, 0).long()).reshape(-1)
        v = torch.where(mask, values, identity_of(op, values.dtype))
        inbox, msgs, pw = _dense_combine(
            idx, v.reshape(-1), mask.reshape(-1), op, M, M, n_loc, own)
    stats = {"msgs_combined": msgs, "per_worker_combined": pw}
    stats.update(base)
    return inbox, stats


def push_combined_flat(targets: torch.Tensor, values: torch.Tensor,
                       mask: torch.Tensor, src_worker: torch.Tensor,
                       op: str, M: int, n_loc: int,
                       backend: str = "dense",
                       plan: Optional[planlib.EdgePlan] = None,
                       log_of: Optional[np.ndarray] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CSR-layout twin of ``push_combined``: flat (E,) per-edge arrays with
    explicit per-edge source workers.  Under a split partition
    ``src_worker`` holds physical shard ids and ``log_of`` ((M_src,)
    shard -> logical map) keeps crossness and the (M,) ``per_worker_*``
    report logical."""
    _check_backend(backend)
    planlib._scalar_only(values, 1)
    device = values.device
    src_worker = src_worker.long()
    log_t = (None if log_of is None
             else torch.as_tensor(np.asarray(log_of), device=device).long())
    wlog = src_worker if log_t is None else log_t[src_worker]
    cross = mask & (torch.div(targets, n_loc, rounding_mode="floor") != wlog)
    base = {"msgs_basic": cross.sum(),
            "per_worker_basic": per_worker(wlog, cross, M)}

    if backend == "pallas":
        if plan is not None:
            masked = torch.where(mask, values, identity_of(op, values.dtype))
            inbox, (msgs, pw) = planlib.combine_with_plan(
                plan, masked, op, count_cross=True, log_of=log_of,
                M_out=M, flat_hits=mask)
        else:
            inbox, (msgs, pw) = planlib.combine_sorted_flat(
                targets, values, mask, src_worker, op, M, n_loc,
                log_of=log_of)
    else:
        n_pad = M * n_loc
        M_src = M if log_t is None else len(log_t)
        row_log = torch.arange(M, device=device) if log_t is None else log_t
        idx = src_worker * n_pad + torch.where(mask, targets, 0).long()
        v = torch.where(mask, values, identity_of(op, values.dtype))
        inbox, msgs, pw = _dense_combine(
            idx, v, mask, op, M_src, M, n_loc, row_log)
    stats = {"msgs_combined": msgs, "per_worker_combined": pw}
    stats.update(base)
    return inbox, stats


def push_mirror(pg: PartitionedGraph, vals: torch.Tensor,
                active: torch.Tensor, op: str, relay: str = "none",
                backend: str = "dense"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Broadcast each active mirrored vertex's value to its mirrors, fan out
    locally.  vals, active: (M, n_loc).  relay='add_w' adds the edge weight
    at the mirror (the paper's relay() for SSSP)."""
    _check_backend(backend)
    planlib._scalar_only(vals, 2)
    ident = identity_of(op, vals.dtype)
    n_pad = pg.n_pad
    flat_vals = vals.reshape(-1)
    flat_act = active.reshape(-1)
    # mir_ids pads with n_pad: clamp before reading (an index past the end
    # would fault on the card) and mask the padding out
    safe = pg.mir_ids.long().clamp(0, n_pad - 1)
    valid = pg.mir_ids < n_pad
    mir_act = valid & flat_act[safe]
    mir_vals = torch.where(mir_act, flat_vals[safe], ident)
    # ^ one value per mirrored vertex: the all-gather payload (Ch_mir send)

    raw = mir_vals[pg.mir_esrc.long()]
    ev = relay_values(raw, pg.mir_ew, relay)
    ev = torch.where(pg.mir_emask & (raw != ident), ev, ident)
    if backend == "pallas":
        inbox, _ = planlib.combine_with_plan(
            planlib.get_plan(pg, "mir"), ev.reshape(-1), op,
            count_cross=False)
    else:
        if pg.layout == "csr":
            # mir_edst is global in csr: per-worker fan-out buffers are
            # disjoint slices of one flat (n_pad,) scatter
            idx = pg.mir_edst.long()
        else:
            row = torch.arange(pg.M, device=vals.device)[:, None]
            idx = (row * pg.n_loc
                   + torch.where(pg.mir_emask, pg.mir_edst, 0)).reshape(-1)
        buf = torch.full((n_pad,), ident, dtype=vals.dtype,
                         device=vals.device)
        inbox = scatter_op(op, buf, idx, ev.reshape(-1)).view(pg.M, pg.n_loc)
    # mask-driven accounting: an ACTIVE mirrored vertex is broadcast to its
    # hosting workers whatever its value (even one equal to the identity)
    sent = torch.where(mir_act, pg.mir_nworkers.long(), 0)
    owner_w = torch.div(safe, pg.n_loc, rounding_mode="floor").clamp(
        0, pg.M - 1)
    return inbox, {"msgs_mirror": sent.sum(),
                   "per_worker_mirror": per_worker(owner_w, sent, pg.M)}


def broadcast(pg: PartitionedGraph, vals: torch.Tensor,
              active: torch.Tensor, op: str, relay: str = "none",
              use_mirroring: bool = True, backend: str = "dense"
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full paper pipeline: low-degree vertices push through Ch_msg with
    combining; high-degree (>= pg.tau) vertices through Ch_mir.  ``vals``
    is each vertex's broadcast value; relay folds edge fields.
    use_mirroring=False routes EVERY edge through Ch_msg (Pregel-noM).
    backend="pallas" drives both channels through the precomputed message
    plans and the segment_combine kernel; inboxes and stats are unchanged.
    ``pg.layout`` picks the edge representation; results and stats are
    layout-invariant."""
    _check_backend(backend)
    kind = "eg" if use_mirroring else "all"
    esrc = getattr(pg, f"{kind}_src").long()
    edst = getattr(pg, f"{kind}_dst")
    emask = getattr(pg, f"{kind}_mask")
    ew = getattr(pg, f"{kind}_w")
    plan = planlib.get_plan(pg, kind) if backend == "pallas" else None
    if pg.layout == "csr":
        src_val = vals.reshape(-1)[esrc]         # esrc is global in csr
        src_act = active.reshape(-1)[esrc]
        v = relay_values(src_val, ew, relay)
        worker, log_of = _flat_worker(pg, kind)
        inbox, stats = push_combined_flat(edst, v, emask & src_act,
                                          worker, op, pg.M, pg.n_loc,
                                          backend=backend, plan=plan,
                                          log_of=log_of)
    else:
        src_val = torch.gather(vals, 1, esrc)
        src_act = torch.gather(active, 1, esrc)
        v = relay_values(src_val, ew, relay)
        inbox, stats = push_combined(edst, v, emask & src_act, op,
                                     pg.M, pg.n_loc, backend=backend,
                                     plan=plan)
    if use_mirroring:
        inbox2, s2 = push_mirror(pg, vals, active, op, relay,
                                 backend=backend)
        inbox = _COMBINE[op](inbox, inbox2)
        stats.update(s2)
    else:
        stats["msgs_mirror"] = torch.zeros((), dtype=torch.int64,
                                           device=vals.device)
        stats["per_worker_mirror"] = torch.zeros(pg.M, dtype=torch.int64,
                                                 device=vals.device)
    stats["msgs_total"] = stats["msgs_combined"] + stats["msgs_mirror"]
    stats["per_worker_total"] = (stats["per_worker_combined"]
                                 + stats["per_worker_mirror"])
    return inbox, stats
