"""Sharded superstep executor over ``torch.distributed``: the worker axis
as D real devices (the counterpart of ``repro.core.exec``).

On one device the engine simulates the paper's M workers as a batch axis.
Here the simulation is *distributed*: one process per device (SPMD), the
default process group of world size D, and rank r owns the workers
``[r*m, (r+1)*m)`` with m = M/D.  The caller initializes the group and
picks its backend (NCCL between GPUs, one GPU a rank; gloo between CPU
processes); the executor never picks one and never moves a tensor to the
host to exchange it.

Host tables: every rank builds the same numpy tables from the same
partition (``_shard_graph``, stacked with a leading device axis as the
reference stacks them for ``shard_map``) and moves only its own slice to
its device, so the device footprint is O(n/D + E/D).  The tables are built
once per (partition, mesh, rank, device, pipeline) and cached on the
partition; the message plans of a kind are added the first time a run
needs them.

Every channel join is destination-routed, as in the reference:

* Ch_msg, pallas backend: each rank runs the scalar ``segment_combine``
  kernel on its own packed plan rows (``_combine_with_plan_sharded``); the
  per-(source, block) segment partials then take ONE ``all_to_all`` to the
  ranks that own their blocks, through index lists built at stack time
  (exact caps, the runtime never overflows them).
* Ch_msg, dense backend, and the runtime-target scatters (S-V hooking, MSF
  election): the sorted segmented combine (``plan.sorted_segments*``)
  reduces duplicate (source, target) pairs locally, and the surviving
  segments travel to their owners in cap-sized ``all_to_all`` rounds
  (``_routed_scatter_combine``).  The round count is the all-reduced
  maximum, read on the host once a join: a hot destination costs extra
  rounds, never lanes.
* Ch_mir: mirror values travel from the owner rank to exactly the ranks
  that host fan-out edges for them, through a static fetch plan (one
  ``all_to_all``); the fan-out runs on the local mirror edges.
* Ch_req: a two-way trip (``_routed_fetch``): deduplicated requests go to
  their owners in rounds, owners answer from their local rows, responses
  come back on the same lanes.

The (hosts, per_host) mesh (``devices=(H, T)``): the default group of
world size H*T read row-major, flat rank d = h*T + t, with the host and
column subgroups of ``launch/mesh.py``.  Every routed join becomes
hierarchical: lanes first go to the device of their destination column
within the sender's host (an ``all_to_all`` over the host group), that
device combines what it received by destination (requests: deduplicates;
the paper's Theorems 1 and 3 applied per level), and only the combined
residue crosses hosts (an ``all_to_all`` over the column group).  Plan
exchanges and fetch plans run in the same two legs from static tables.
``(1, T)`` and ``(H, 1)`` take these paths too.

Load balancing (``balance="split"``): the partition's physical shards
(hot workers cut at csr row offsets) are the unit of device placement;
``device_edge_bounds`` packs contiguous shard runs onto devices by edge
load.  A logical worker's shards may then sit on other devices than its
vertex rows, so each rank reads its edges' source values through a static
fetch plan (never an all-gather of the state), keys sender-side combining
and request dedup by physical shard (``*_pw``; a shard never straddles
devices, so the per-rank counts sum exactly), and routes the mirror
fan-out through the exchange.

The pipeline (``pipeline=True``): each routed exchange is cut into about
``pipeline_chunks`` cap-sized rounds and each plan exchange into static
position chunks; round or chunk c's ``all_to_all`` is issued
(``async_op=True``) before c-1's received lanes are combined, two receive
buffers alive at a time, and every send buffer kept until its ``wait()``.
The combines still run in the order c = 0, 1, ..., so min, max and
integer results stay bitwise; only float sums change their scatter order.
On the 2-D mesh the inter-host leg is the one pipelined.

Collectives (``ShardedGraph``): ``all_to_all_single`` on (K, cap, ...)
buffers with equal splits over the default group or a subgroup;
``gany``/``gall`` as an int32 ``all_reduce`` (gloo has no bool
reduction); ``gsum`` and ``gmax`` as ``all_reduce``.  Round counts are
all-reduced over the whole default group, inner (inter-host) rounds too,
so every rank issues the same collectives in the same order.  The message
counts are not reduced inside a superstep: every rank keeps its own int64
partial counts, and ``run_sharded`` / ``apply_sharded`` reduce the totals
(and the history) with one ``all_reduce`` each at the end of the run.

Loops: the reference's ``lax.fori_loop`` over exchange rounds is a Python
loop over the host-read round count; ``bsp.run`` votes ``halted`` over all
ranks before its one host read a superstep.

Parity contract (``tests/test_torch_sharded.py``,
``tests/test_torch_sharded_mesh.py``, ``tests/test_torch_sharded_gnn.py``):
any mesh, split or pipeline gives the single-device result bitwise for
integer, min and max combines, sums (PageRank, gSpMM, the GCN's loss) to
float round-off, and every ``msgs_*`` / ``per_worker_*`` integer-exact, in
the same number of supersteps.

Feature-blocked payloads ``(..., F)`` (the sharded GNN path: gSpMM joins,
GCN training, embedding fetches) ride every channel: the routed exchanges
and fetch plans carry an (F,) row a lane, under the pipeline at a cap
shrunk by F (``_pipeline_cap``), and the plan combine runs each rank's
rows through the vector kernel in ``plan.vec_chunk_rows`` chunks, merged
straight into the rank's blocks or into the send slots of the segments
that leave it (``VecPlan``), so no (n_segs, nb, F) buffer exists.  A
mirror fetch carries the mirrors' activity explicitly (a feature may
equal the identity).

Frozen shard profiles (the graph service, ``core/service.py``): a
``ShardProfile`` freezes the content-decided shapes of a csr partition's
tables on the 1-D mesh (per-device edge caps, the mirror-id table, the
mirror fetch plan, the routing cap hint) with headroom; ``shard(...,
profile=)`` pads this rank's tables to it, and ``reshard`` writes a
folded graph's tables into the resident tensors in place, so the step
functions built on that ShardedGraph keep running on it after a fold.  A
graph that outgrows the envelope raises ``ProfileOverflow``.
``run_on`` runs a built step on a resident ShardedGraph; ``run_sharded``
is ``shard`` and then ``run_on``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bsp
from repro_torch.core import cost_model
from repro_torch.core import plan as planlib
from repro_torch.core.channels import _dedup_row, _edge_map, relay_values
from repro_torch.core.plan import (EdgeMap, feat_mask, feat_shape,
                                   identity_of, per_worker, scatter_op)
from repro_torch.launch import mesh as meshlib

_MERGE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}

#: exchange chunks a join when the pipeline is on: two is the least that
#: overlaps at all (one exchange in flight beside one combining); each
#: further chunk costs another collective and kernel launch a join.  On a
#: one-device mesh the default is 1 (the exchange is a local copy), as in
#: the reference; an explicit ``pipeline_chunks`` still forces it.
DEFAULT_PIPELINE_CHUNKS = 2


def broadcast_plan_kinds(backend: str, use_mirroring: bool = True) -> tuple:
    """The message plans the executor builds per device for one
    ``channels.broadcast`` configuration."""
    if backend != "pallas":
        return ()
    return ("eg", "mir") if use_mirroring else ("all",)


def _normalize_devices(devices):
    """``devices`` is an int (the 1-D worker mesh) or a ``(hosts,
    per_host)`` pair (the 2-D mesh; (1, T) and (H, 1) included).  Returns
    ``(D, hier)`` with ``hier`` None or ``(H, T)``."""
    if isinstance(devices, (tuple, list)):
        H, T = int(devices[0]), int(devices[1])
        if H < 1 or T < 1:
            raise ValueError(f"bad (hosts, devices) mesh {devices!r}")
        return H * T, (H, T)
    return int(devices), None


def _pad8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


def _cap_for(L: int, D: int, hint: Optional[int] = None) -> int:
    """Per-destination-device lane cap of one routed-exchange round:
    ``ceil(L/D)`` (exact for balanced traffic), widened up to 4x by
    ``hint`` (the worst static per-device-pair traffic) so known skew
    still lands in one round."""
    base = -(-L // D)
    cap = base if hint is None else max(base, min(int(hint), 4 * base))
    return min(_pad8(cap), _pad8(L))


def _chunks_of(D: int, pipeline: bool, pipeline_chunks: Optional[int]):
    """The pipeline's chunk count (None when it is off)."""
    if not pipeline:
        return None
    return pipeline_chunks or (DEFAULT_PIPELINE_CHUNKS if D > 1 else 1)


# ---------------------------------------------------------------------------
# host tables: device bounds, per-device plans, fetch plans, reports
# ---------------------------------------------------------------------------

def _is_split(pg) -> bool:
    return getattr(pg, "phys_log", None) is not None


def csr_device_bounds(off: np.ndarray, M: int, D: int) -> np.ndarray:
    """(D+1,) edge offsets at device boundaries of a (M+1,) worker csr."""
    m = M // D
    return np.asarray(off)[np.arange(0, M + 1, m)]


def device_edge_bounds(pg, devices) -> Dict[str, np.ndarray]:
    """Per-device (D+1,) edge bounds of each csr edge set, in the flat
    device order (``devices`` an int or an ``(H, T)`` pair).  Default
    partitions cut at worker multiples (m = M/D workers a device); split
    partitions between physical shards, packed contiguously to minimize
    the largest per-device eg + mirror edge load (``"phys"`` holds the
    shard bounds)."""
    D, _ = _normalize_devices(devices)
    if _is_split(pg):
        loads = np.diff(pg.phys_eg_off) + np.diff(pg.phys_mir_off)
        pb = cost_model.contiguous_bounds(loads, D)
        return {"phys": pb,
                "eg": np.asarray(pg.phys_eg_off)[pb],
                "all": np.asarray(pg.phys_all_off)[pb],
                "mir": np.asarray(pg.phys_mir_off)[pb]}
    return {"phys": None,
            "eg": csr_device_bounds(pg.eg_off, pg.M, D),
            "all": csr_device_bounds(pg.all_off, pg.M, D),
            "mir": csr_device_bounds(pg.mir_eoff, pg.M, D)}


def device_edge_loads(pg, devices) -> np.ndarray:
    """(D,) per-device superstep edge load (Ch_msg + mirror fan-out) of
    the device placement."""
    b = device_edge_bounds(pg, devices)
    return np.diff(b["eg"]) + np.diff(b["mir"])


def crossness_report(pg, devices=None) -> Dict[str, float]:
    """Static locality accounting from the partition's ``pair_counts``:
    the fraction of combined messages (distinct (source worker,
    destination vertex) pairs, what one full-broadcast superstep puts on
    the wire) that crosses a worker, device or host boundary.  Devices
    are uniform worker blocks of m = M/D; an ``(H, T)`` mesh adds host
    blocks of M/H.  Split partitions pack physical shards onto devices,
    so their device and host rows are the logical-block approximation."""
    pc = np.asarray(pg.pair_counts, np.int64)
    M = pg.M
    total = int(pc.sum())

    def _frac(cross):
        return float(cross) / total if total else 0.0

    cross_w = total - int(np.trace(pc))
    rep = {"total": total, "cross_worker": cross_w,
           "cross_worker_frac": _frac(cross_w)}
    if devices is not None:
        D, hier = _normalize_devices(devices)
        if M % D:
            raise ValueError(f"M={M} must divide over D={D} devices")
        m = M // D
        blocks = pc.reshape(D, m, D, m).sum(axis=(1, 3))
        cross_d = total - int(np.trace(blocks))
        rep.update(D=D, cross_device=cross_d,
                   cross_device_frac=_frac(cross_d))
        if hier is not None:
            H, T = hier
            hb = blocks.reshape(H, T, H, T).sum(axis=(1, 3))
            cross_h = total - int(np.trace(hb))
            rep.update(H=H, cross_host=cross_h,
                       cross_host_frac=_frac(cross_h))
    return rep


def _device_plans(pg, D: int, kind: str, nb: int):
    """One EdgePlan per device over that device's edges, with *global*
    source workers in ``seg_worker`` (the accounting; physical shard ids
    under a split partition, whose device slices follow the shard bounds)
    and *global* destination blocks (the exchange's address space)."""
    if D == 1:
        # one device's plan is the single-device plan: share its packing
        return [planlib.get_plan(pg, kind, nb)]
    M, n_loc = pg.M, pg.n_loc
    m = M // D
    h = pg.host
    split = _is_split(pg)
    dbounds = device_edge_bounds(pg, D) if split else None

    def build(d, eb):
        if pg.layout == "csr":
            M_src = pg.M_phys if split else M
            if kind in ("eg", "all"):
                src, dst = h[f"{kind}_src"], h[f"{kind}_dst"]
                if split:
                    s, e = int(dbounds[kind][d]), int(dbounds[kind][d + 1])
                    sw = h[f"{kind}_pw"][s:e]
                else:
                    off = pg.eg_off if kind == "eg" else pg.all_off
                    s, e = int(off[d * m]), int(off[(d + 1) * m])
                    sw = src[s:e] // n_loc
            else:
                dst = h["mir_edst"]
                if split:
                    s, e = int(dbounds["mir"][d]), int(dbounds["mir"][d + 1])
                    sw = h["mir_pw"][s:e]
                else:
                    s = int(pg.mir_eoff[d * m])
                    e = int(pg.mir_eoff[(d + 1) * m])
                    sw = dst[s:e] // n_loc
            return planlib.build_edge_plan_flat(
                sw, dst[s:e] // n_loc, dst[s:e] % n_loc, M_src, M, n_loc, nb,
                eb)
        sl = slice(d * m, (d + 1) * m)
        if kind in ("eg", "all"):
            dst = h[f"{kind}_dst"][sl]
            p = planlib.build_edge_plan(dst // n_loc, dst % n_loc,
                                        h[f"{kind}_mask"][sl], M, n_loc, nb,
                                        eb)
        else:
            edst = h["mir_edst"][sl]
            own = np.broadcast_to(np.arange(d * m, (d + 1) * m)[:, None],
                                  edst.shape)
            p = planlib.build_edge_plan(own, edst, h["mir_emask"][sl], M,
                                        n_loc, nb, eb)
        # build_edge_plan derives source workers from the local row index
        p.seg_worker = (p.seg_worker + d * m).astype(np.int32)
        return p

    plans = [build(d, None) for d in range(D)]
    eb = max(p.eb for p in plans)
    return [p if p.eb == eb else build(d, eb) for d, p in enumerate(plans)]


def _stack_plans(plans, m: int, chunks: Optional[int] = None,
                 hier: Optional[Tuple[int, int]] = None):
    """Pad the per-device plans to common row / segment counts, build the
    per-destination-device exchange index lists, and stack everything with
    a leading device axis.  Returns ``(meta, arrays)``.

    Dummy rows have ``row_valid`` all False (they combine to the identity
    into segment 0) and dummy segments are left out of the exchange lists.
    ``xseg``/``xval`` list MY segments per destination device (send
    side); ``rblk``/``rval`` give, per source device, the local block of
    each segment routed to me (receive side).  Both are static, so the
    ``all_to_all`` caps are exact.  ``hier=(H, T)`` adds the two-leg
    tables of ``_hier_plan_tables``; ``chunks`` (the pipeline) the chunk
    tables of ``_chunk_plans``, or on the 2-D mesh the inter-host leg's
    chunk count."""
    D = len(plans)
    nb, eb = plans[0].nb, plans[0].eb
    bpd = m * plans[0].B_per_w               # destination blocks per device
    R = max(1, max(p.n_rows for p in plans))
    S = max(1, max(p.n_segs for p in plans))
    pair = {}
    xcap = 1
    for d, p in enumerate(plans):
        dd = p.seg_blk // bpd if p.n_segs else np.zeros(0, np.int64)
        for d2 in range(D):
            sel = np.flatnonzero(dd == d2)
            pair[(d, d2)] = sel
            xcap = max(xcap, len(sel))
    a = {
        "row_gather": np.zeros((D, R, eb), np.int32),
        "row_valid": np.zeros((D, R, eb), bool),
        "row_local": np.full((D, R, eb), -1, np.int32),
        "row_seg": np.zeros((D, R), np.int32),
        "seg_blk": np.zeros((D, S), np.int32),
        "seg_worker": np.zeros((D, S), np.int32),
        "xseg": np.zeros((D, D, xcap), np.int32),
        "xval": np.zeros((D, D, xcap), bool),
        "rblk": np.zeros((D, D, xcap), np.int32),
        "rval": np.zeros((D, D, xcap), bool),
    }
    for d, p in enumerate(plans):
        a["row_gather"][d, :p.n_rows] = p.row_gather
        a["row_valid"][d, :p.n_rows] = p.row_valid
        a["row_local"][d, :p.n_rows] = p.row_local
        a["row_seg"][d, :p.n_rows] = p.row_seg
        a["seg_blk"][d, :p.n_segs] = p.seg_blk
        a["seg_worker"][d, :p.n_segs] = p.seg_worker
    for (d, d2), sel in pair.items():
        c = len(sel)
        a["xseg"][d, d2, :c] = sel
        a["xval"][d, d2, :c] = True
        a["rblk"][d2, d, :c] = plans[d].seg_blk[sel] - d2 * bpd
        a["rval"][d2, d, :c] = True
    meta = {"nb": nb, "eb": eb, "B_per_w": plans[0].B_per_w,
            "n_blocks": plans[0].n_blocks, "n_rows": R, "n_segs": S,
            "xcap": xcap}
    if hier is not None:
        meta.update(_hier_plan_tables(plans, a, D, bpd, *hier,
                                      chunks=chunks))
    elif chunks:
        meta.update(_chunk_plans(plans, pair, a, D, bpd, xcap, chunks))
    return meta, a


def _hier_plan_tables(plans, a, D: int, bpd: int, H: int, T: int,
                      chunks: Optional[int] = None):
    """Two-leg static exchange tables of the (H, T) mesh.  Leg 1 (host
    group): device (h, t1) sends each real segment to the device of its
    destination *column* t2 within its host (``x1seg``/``x1val``).  The
    intermediate device (h, t2) combines what it received by global
    destination block (``iscat``/``ival`` into ``n_iseg`` segments: two
    senders' segments aimed at one block merge before crossing hosts).
    Leg 2 (column group): only the combined residue travels to the owner
    host (``x2seg``/``x2val`` send, ``r2blk``/``r2val`` receive).  Lanes
    are position-aligned across each ``all_to_all``, so the caps are
    exact."""
    x1list = {}
    x1cap = 1
    for d, p in enumerate(plans):
        dd = p.seg_blk // bpd if p.n_segs else np.zeros(0, np.int64)
        for t2 in range(T):
            sel = np.flatnonzero(dd % T == t2)
            x1list[(d, t2)] = sel
            x1cap = max(x1cap, len(sel))

    # the intermediate combine: per device (h, t2) the distinct
    # destination blocks among its received lanes
    iblocks = {}
    n_iseg = 1
    for h in range(H):
        for t2 in range(T):
            i = h * T + t2
            gbs = [plans[h * T + t1].seg_blk[x1list[(h * T + t1, t2)]]
                   for t1 in range(T)]
            iblocks[i] = np.unique(np.concatenate(gbs))
            n_iseg = max(n_iseg, len(iblocks[i]))

    # leg-2 residue lists: intermediate segments by destination host
    x2list = {}
    x2cap = 1
    for i in range(D):
        dh = (iblocks[i] // bpd) // T
        for h2 in range(H):
            sel = np.flatnonzero(dh == h2)
            x2list[(i, h2)] = sel
            x2cap = max(x2cap, len(sel))

    x1seg = np.zeros((D, T, x1cap), np.int32)
    x1val = np.zeros((D, T, x1cap), bool)
    iscat = np.zeros((D, T, x1cap), np.int32)
    ival = np.zeros((D, T, x1cap), bool)
    x2seg = np.zeros((D, H, x2cap), np.int32)
    x2val = np.zeros((D, H, x2cap), bool)
    r2blk = np.zeros((D, H, x2cap), np.int32)
    r2val = np.zeros((D, H, x2cap), bool)
    for h in range(H):
        for t2 in range(T):
            i = h * T + t2
            for t1 in range(T):
                s = h * T + t1
                sel = x1list[(s, t2)]
                c = len(sel)
                x1seg[s, t2, :c] = sel
                x1val[s, t2, :c] = True
                iscat[i, t1, :c] = np.searchsorted(iblocks[i],
                                                   plans[s].seg_blk[sel])
                ival[i, t1, :c] = True
            for h2 in range(H):
                sel = x2list[(i, h2)]
                c = len(sel)
                o = h2 * T + t2
                x2seg[i, h2, :c] = sel
                x2val[i, h2, :c] = True
                r2blk[o, h, :c] = iblocks[i][sel] - o * bpd
                r2val[o, h, :c] = True
    a.update(x1seg=x1seg, x1val=x1val, iscat=iscat, ival=ival,
             x2seg=x2seg, x2val=x2val, r2blk=r2blk, r2val=r2val)
    return {"x1cap": x1cap, "n_iseg": n_iseg, "x2cap": x2cap,
            "hchunks": max(1, min(int(chunks or 1), x2cap))}


def _chunk_plans(plans, pair, a, D: int, bpd: int, xcap: int, chunks: int):
    """Pipeline chunk tables of the 1-D plan exchange.  Chunk c covers
    positions [c*ccap, (c+1)*ccap) of every pair's exchange list, the
    same window on sender and receiver, so a chunk's ``all_to_all`` caps
    stay exact.  Every real segment lands in exactly one chunk, hence
    every real row in exactly one chunk's row table (``crow``, with the
    chunk-local segment ``crow_seg``): the chunks partition the combine.
    Within a chunk, segments are numbered by (destination device,
    position) and rows by (segment, row), the reference's order, computed
    here with sorts instead of a loop over segments."""
    ccap = max(1, -(-xcap // max(int(chunks), 1)))
    C = -(-xcap // ccap)
    per = []
    for d, p in enumerate(plans):
        S = p.n_segs
        dst = (p.seg_blk // bpd).astype(np.int64)
        pos = np.zeros(S, np.int64)
        for d2 in range(D):
            sel = pair[(d, d2)]
            pos[sel] = np.arange(len(sel))
        c_of = pos // ccap
        order = np.lexsort((pos, dst, c_of))
        start = np.concatenate([[0], np.cumsum(np.bincount(
            c_of, minlength=C))[:-1]])
        local = np.zeros(S, np.int64)
        local[order] = np.arange(S) - start[c_of[order]]
        rs = np.asarray(p.row_seg, np.int64)
        rc = c_of[rs]
        rorder = np.lexsort((np.arange(len(rs)), local[rs], rc))
        rcount = np.bincount(rc, minlength=C)
        per.append((dst, pos, c_of, local, rs, rorder, rcount,
                    np.bincount(c_of, minlength=C)))
    CR = max(1, max(int(x[6].max()) for x in per))
    CS = max(1, max(int(x[7].max()) for x in per))
    crow = np.zeros((D, C, CR), np.int32)
    crow_ok = np.zeros((D, C, CR), bool)
    crow_seg = np.zeros((D, C, CR), np.int32)
    cxseg = np.zeros((D, C, D, ccap), np.int32)
    cxval = np.zeros((D, C, D, ccap), bool)
    crblk = np.zeros((D, C, D, ccap), np.int32)
    crval = np.zeros((D, C, D, ccap), bool)
    for d, (dst, pos, c_of, local, rs, rorder, rcount, _) in enumerate(per):
        rstart = np.concatenate([[0], np.cumsum(rcount)[:-1]])
        rc = c_of[rs[rorder]]
        k = np.arange(len(rs)) - rstart[rc]
        crow[d, rc, k] = rorder
        crow_ok[d, rc, k] = True
        crow_seg[d, rc, k] = local[rs[rorder]]
        j = pos % ccap
        cxseg[d, c_of, dst, j] = local
        cxval[d, c_of, dst, j] = True
        crblk[dst, c_of, d, j] = plans[d].seg_blk - dst * bpd
        crval[dst, c_of, d, j] = True
    a.update(crow=crow, crow_ok=crow_ok, crow_seg=crow_seg,
             cxseg=cxseg, cxval=cxval, crblk=crblk, crval=crval)
    return {"n_chunks": C, "ccap": ccap, "cr": CR, "cs": CS}


def _build_fetch_plan(need_lists, D: int, loc_n: int,
                      hier: Optional[Tuple[int, int]] = None):
    """``need_lists``: per-device sorted unique GLOBAL slot ids; the owner
    of slot g is ``g // loc_n``.  Returns ``(meta, arrays)``: per device
    the LOCAL slots it sends to each consumer (``send_slot``, -1 pad) and
    the compact position of each value it receives (``recv_pos``, -1
    pad); on the 2-D mesh the two-leg tables of
    ``_build_fetch_plan_hier``."""
    n_need = max(1, max((len(x) for x in need_lists), default=1))
    if hier is not None:
        return _build_fetch_plan_hier(need_lists, loc_n, *hier, n_need)
    cap = 1
    pair = {}
    for d, need in enumerate(need_lists):
        need = np.asarray(need, np.int64)
        bounds = np.searchsorted(need, np.arange(D + 1) * loc_n)
        for s in range(D):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            pair[(s, d)] = (need[lo:hi], np.arange(lo, hi))
            cap = max(cap, hi - lo)
    send_slot = np.full((D, D, cap), -1, np.int32)
    recv_pos = np.full((D, D, cap), -1, np.int32)
    for (s, d), (slots, pos) in pair.items():
        c = len(slots)
        send_slot[s, d, :c] = slots - s * loc_n
        recv_pos[d, s, :c] = pos
    return ({"cap": cap, "n_need": n_need},
            {"send_slot": send_slot, "recv_pos": recv_pos})


def _build_fetch_plan_hier(need_lists, loc_n: int, H: int, T: int,
                           n_need: int):
    """Two-leg fetch tables through a per-host *gateway*: the owner (h_o,
    t) sends each value once per consuming host, to device (h_c, t), the
    gateway of column t there (leg A, column group), and the gateway fans
    it out to the consumers within its host (leg B, host group).  A
    value's cross-host cost is the number of hosts needing it, never the
    number of devices (Theorem 1 per level)."""
    D = H * T
    gw_set = {}
    n_gw = 1
    for hc in range(H):
        lists = [np.asarray(need_lists[hc * T + t], np.int64)
                 for t in range(T)]
        host_need = np.unique(np.concatenate(lists))
        own_col = (host_need // loc_n) % T
        for to in range(T):
            gw_set[(hc, to)] = host_need[own_col == to]
            n_gw = max(n_gw, len(gw_set[(hc, to)]))

    cap_a = 1
    a_pairs = {}
    for (hc, to), s in gw_set.items():
        owner_host = s // (loc_n * T)
        bounds = np.searchsorted(owner_host, np.arange(H + 1))
        for ho in range(H):
            lo, hi = int(bounds[ho]), int(bounds[ho + 1])
            a_pairs[(ho, hc, to)] = (s[lo:hi], np.arange(lo, hi))
            cap_a = max(cap_a, hi - lo)
    cap_b = 1
    b_pairs = {}
    for hc in range(H):
        for tc in range(T):
            need = np.asarray(need_lists[hc * T + tc], np.int64)
            own_col = (need // loc_n) % T
            for to in range(T):
                sel = np.flatnonzero(own_col == to)
                gpos = np.searchsorted(gw_set[(hc, to)], need[sel])
                b_pairs[(to, tc, hc)] = (gpos, sel)
                cap_b = max(cap_b, len(sel))

    a_send = np.full((D, H, cap_a), -1, np.int32)
    a_recv = np.full((D, H, cap_a), -1, np.int32)
    for (ho, hc, to), (slots, pos) in a_pairs.items():
        c = len(slots)
        a_send[ho * T + to, hc, :c] = slots - (ho * T + to) * loc_n
        a_recv[hc * T + to, ho, :c] = pos
    b_send = np.full((D, T, cap_b), -1, np.int32)
    b_recv = np.full((D, T, cap_b), -1, np.int32)
    for (to, tc, hc), (gpos, pos) in b_pairs.items():
        c = len(gpos)
        b_send[hc * T + to, tc, :c] = gpos
        b_recv[hc * T + tc, to, :c] = pos
    return ({"n_need": n_need, "n_gw": n_gw, "cap_a": cap_a,
             "cap_b": cap_b},
            {"a_send": a_send, "a_recv": a_recv,
             "b_send": b_send, "b_recv": b_recv})


def _pad_device_slices(arr: np.ndarray, bounds: np.ndarray, pad_row):
    """Slice a flat (E,) array at ``bounds`` into (D, cap) with per-device
    padding values ``pad_row[d]``; also returns the validity mask."""
    D = len(bounds) - 1
    counts = np.diff(bounds)
    cap = max(1, int(counts.max()))
    out = np.empty((D, cap), arr.dtype)
    valid = np.zeros((D, cap), bool)
    for d in range(D):
        c = int(counts[d])
        out[d, :c] = arr[bounds[d]:bounds[d + 1]]
        out[d, c:] = pad_row[d]
        valid[d, :c] = True
    return out, valid


def _cap_hint(pg, D: int) -> Optional[int]:
    """The worst per-device-pair distinct-target count from the
    partition's (M, M) ``pair_counts``: the initial cap of the routed
    edge-shaped exchanges (None for a split partition, whose device
    bounds do not follow worker blocks)."""
    pc = pg.pair_counts
    if pc is None or _is_split(pg):
        return None
    m = pg.M // D
    return int(pc.reshape(D, m, D, m).sum(axis=(1, 3)).max())


def _cap_hints_2d(pg, D: int, H: int, T: int
                  ) -> Tuple[Optional[int], Optional[int]]:
    """Level-aware cap hints of the 2-D mesh from ``pair_counts``: the
    intra-host leg's worst (source device, destination column) traffic,
    and the inter-host leg's worst (source host, destination host,
    column) traffic, the pre-combine bound on the residue one
    intermediate device routes to one host."""
    pc = pg.pair_counts
    if pc is None or _is_split(pg):
        return None, None
    m = pg.M // D
    blocks = pc.reshape(D, m, D, m).sum(axis=(1, 3))
    hint_w = int(blocks.reshape(D, H, T).sum(axis=1).max())
    hint_h = int(blocks.reshape(H, T, H, T).sum(axis=1).max())
    return hint_w, hint_h


def _shard_graph(pg, devices, plan_kinds: Sequence[str], nb: int,
                 pipeline: bool = False,
                 pipeline_chunks: Optional[int] = None):
    """The device-stacked host tables of ``pg`` over ``devices`` (an int
    or an ``(H, T)`` pair, the flat device order d = h*T + t): csr edge
    sets sliced at device bounds and padded to the per-device maximum
    (padding sources point at a real slot, masked), padded-layout rows as
    they are (sliced by rows later), the fetch plans (mirror values; the
    split source reads), and the stacked message plans of ``plan_kinds``
    (with the pipeline's chunk tables and the 2-D mesh's two-leg tables).
    Returns ``(meta, arrays)``, arrays with a leading D (csr edges, plans,
    fetch tables) or M (vertex rows, padded edges) axis, or replicated."""
    D, hier = _normalize_devices(devices)
    M, n_loc = pg.M, pg.n_loc
    m = M // D
    loc_n = m * n_loc
    h = pg.host
    split = _is_split(pg)
    chunks = _chunks_of(D, pipeline, pipeline_chunks)
    arrays: Dict[str, np.ndarray] = {
        "vmask": h["vmask"], "deg": h["deg"], "mir_ids": h["mir_ids"],
        "mir_nworkers": h["mir_nworkers"]}
    hint_w, hint_h = _cap_hints_2d(pg, D, *hier) if hier else (None, None)
    meta = {"M": M, "n_loc": n_loc, "D": D, "m_loc": m, "n": pg.n,
            "tau": pg.tau, "layout": pg.layout, "split": split,
            "hier": hier, "cap_hint": _cap_hint(pg, D),
            "cap_hint_w": hint_w, "cap_hint_h": hint_h, "plan_meta": {},
            "fetch_meta": {}, "pipeline": pipeline,
            "pipeline_chunks": chunks or 1}

    def add_fetch(name, need_lists):
        fmeta, farr = _build_fetch_plan(need_lists, D, loc_n, hier=hier)
        meta["fetch_meta"][name] = fmeta
        for k, v in farr.items():
            arrays[f"fetch_{name}_{k}"] = v

    if pg.layout == "csr":
        dbounds = device_edge_bounds(pg, D) if split else None
        if split:
            pb = dbounds["phys"]
            meta.update(M_phys=pg.M_phys, p_bounds=pb,
                        P_loc=int(np.diff(pb).max()),
                        device_edge_load=device_edge_loads(pg, D))
            arrays["phys_log"] = np.asarray(pg.phys_log, np.int32)
        base = np.arange(D) * m * n_loc        # a safe in-range pad id
        zero = np.zeros(D)
        for name, off in (("eg", pg.eg_off), ("all", pg.all_off)):
            bounds = (dbounds[name] if split
                      else csr_device_bounds(off, M, D))
            src, vs = _pad_device_slices(h[f"{name}_src"], bounds, base)
            arrays[f"{name}_src"] = src
            arrays[f"{name}_dst"] = _pad_device_slices(
                h[f"{name}_dst"], bounds, zero)[0]
            arrays[f"{name}_w"] = _pad_device_slices(
                h[f"{name}_w"], bounds, zero)[0]
            arrays[f"{name}_mask"] = vs
            if split:
                arrays[f"{name}_pw"] = _pad_device_slices(
                    h[f"{name}_pw"], bounds, pb[:-1])[0]
                # split bounds cross worker state blocks: the static
                # source-value fetch plan and each edge's compact index
                # (pad sources reuse base[d], a real slot, so pad lanes
                # share a fetched value and stay masked)
                need = [np.unique(src[d]) for d in range(D)]
                add_fetch(name, need)
                arrays[f"{name}_csrc"] = np.stack([
                    np.searchsorted(need[d], src[d]).astype(np.int32)
                    for d in range(D)])
        bounds = (dbounds["mir"] if split
                  else csr_device_bounds(pg.mir_eoff, M, D))
        esrc, vs = _pad_device_slices(h["mir_esrc"], bounds, zero)
        arrays.update(
            mir_esrc=esrc, mir_emask=vs,
            mir_edst=_pad_device_slices(h["mir_edst"], bounds, base)[0],
            mir_ew=_pad_device_slices(h["mir_ew"], bounds, zero)[0])
        if split:
            arrays["mir_pw"] = _pad_device_slices(h["mir_pw"], bounds,
                                                  pb[:-1])[0]
    else:
        for name in ("eg_src", "eg_dst", "eg_mask", "eg_w",
                     "all_src", "all_dst", "all_mask", "all_w",
                     "mir_esrc", "mir_edst", "mir_emask", "mir_ew"):
            arrays[name] = h[name]

    # mirror-value fetch plan: each device needs the state slots of the
    # mirrored vertices referenced by ITS mirror edges (static)
    mir_ids = np.asarray(h["mir_ids"], np.int64)
    n_pad = M * n_loc
    esrc, emask = arrays["mir_esrc"], arrays["mir_emask"]
    if pg.layout != "csr":
        esrc = esrc.reshape(D, m * esrc.shape[1])
        emask = emask.reshape(D, m * emask.shape[1])
    need_lists, cesrc = [], []
    for d in range(D):
        gids = mir_ids[np.clip(esrc[d], 0, len(mir_ids) - 1)]
        ok = emask[d] & (gids < n_pad)
        need = np.unique(gids[ok]) if ok.any() else np.zeros(0, np.int64)
        need_lists.append(need)
        pos = (np.searchsorted(need, gids) if len(need)
               else np.zeros(len(gids), np.int64))
        cesrc.append(np.where(ok, np.clip(pos, 0, max(len(need) - 1, 0)),
                              0).astype(np.int32))
    add_fetch("mir", need_lists)
    arrays["mir_cesrc"] = np.stack(cesrc)
    for kind in plan_kinds:
        meta["plan_meta"][kind], parrs = _stacked_plan(pg, devices, kind, nb,
                                                       chunks)
        arrays.update(parrs)
    return meta, arrays


def _stacked_plan(pg, devices, kind: str, nb: int,
                  chunks: Optional[int] = None):
    """(meta, ``plan_<kind>_*`` arrays) of one kind's stacked plans.  The
    per-device plans (the packing, most of a build's host time) are
    cached on ``pg`` by device count: the 1-D, 2-D and pipelined tables
    of one D stack the same plans."""
    D, hier = _normalize_devices(devices)
    key = ("device_plans", D, kind, nb)
    plans = pg.plan_cache.get(key)
    if plans is None:
        plans = pg.plan_cache[key] = _device_plans(pg, D, kind, nb)
    pmeta, parrs = _stack_plans(plans, pg.M // D, chunks=chunks, hier=hier)
    return pmeta, {f"plan_{kind}_{k}": v for k, v in parrs.items()}


def exchange_volume_report(pg, devices, plan_kinds: Sequence[str] = (),
                           nb: Optional[int] = None) -> dict:
    """Static per-superstep exchange volume from the shard tables (host
    numpy, no device): the wire lanes of every static exchange the
    executor runs a superstep, the plan exchanges (Ch_msg and Ch_mir on
    the pallas backend) and the fetch plans (mirror values, split source
    reads).  On a 1-D mesh every lane between two devices is
    ``intra_host`` and ``cross_host`` is 0.  On an (H, T) mesh the leg-1
    and leg-B lanes leaving their column are ``intra_host`` and the leg-2
    and leg-A lanes leaving their host ``cross_host``: the post-combine
    residue.  ``nb`` defaults to the block width of ``pg``'s device."""
    D, hier = _normalize_devices(devices)
    nb = nb or planlib.default_nb(pg.device)
    meta, arrays = _shard_graph(pg, devices, plan_kinds, nb)
    dev = np.arange(D)
    rep = {"devices": D, "hier": hier, "per_exchange": {}}
    intra = cross = 0

    def off_diag(sent, K, coord):
        return int(sent[coord[:, None] != np.arange(K)[None]].sum())

    for kind in meta["plan_meta"]:
        if hier:
            H, T = hier
            i_k = off_diag(arrays[f"plan_{kind}_x1val"].sum(axis=2), T,
                           dev % T)
            c_k = off_diag(arrays[f"plan_{kind}_x2val"].sum(axis=2), H,
                           dev // T)
        else:
            snd = arrays[f"plan_{kind}_xval"].sum(axis=2)
            i_k, c_k = int(snd.sum() - np.trace(snd)), 0
        rep["per_exchange"][f"plan_{kind}"] = {"intra_host": i_k,
                                               "cross_host": c_k}
        intra, cross = intra + i_k, cross + c_k
    for name in meta["fetch_meta"]:
        if hier:
            H, T = hier
            c_k = off_diag((arrays[f"fetch_{name}_a_send"] >= 0).sum(axis=2),
                           H, dev // T)
            i_k = off_diag((arrays[f"fetch_{name}_b_send"] >= 0).sum(axis=2),
                           T, dev % T)
        else:
            snd = (arrays[f"fetch_{name}_send_slot"] >= 0).sum(axis=2)
            i_k, c_k = int(snd.sum() - np.trace(snd)), 0
        rep["per_exchange"][f"fetch_{name}"] = {"intra_host": i_k,
                                                "cross_host": c_k}
        intra, cross = intra + i_k, cross + c_k
    rep.update(intra_host=intra, cross_host=cross, total=intra + cross)
    return rep


# ---------------------------------------------------------------------------
# frozen shard profiles: the graph service's resident tables
# ---------------------------------------------------------------------------
#
# The reference freezes these shapes so that its compiled programs never
# re-trace; here nothing is compiled, and the profile keeps the resident
# tensors themselves: a fold of the graph is padded to the same envelope
# and copied into the same storage, so step functions built on the
# ShardedGraph (the service's resident executors) stay valid.  Padding is
# semantics-free (masked lanes carry nothing), and a frozen cap hint only
# changes how many rounds a routed exchange takes, never its result.

class ProfileOverflow(ValueError):
    """The graph outgrew its frozen ShardProfile: build a new one."""


@dataclasses.dataclass(frozen=True)
class ShardProfile:
    """Frozen shape envelope of a resident ShardedGraph (csr layout, 1-D
    mesh, no split, no message plans)."""
    D: int
    eg_cap: int        # per-device Ch_msg edge rows
    all_cap: int       # per-device full-adjacency rows
    mir_cap: int       # per-device mirror fan-out rows
    n_mir: int         # replicated mirror-id table length
    fetch_cap: int     # mirror fetch plan per-device-pair lanes
    fetch_need: int    # mirror fetch plan compact buffer length
    cap_hint: Optional[int]  # frozen pair_counts routing cap


def _profile_supported(meta) -> None:
    if meta["layout"] != "csr":
        raise ValueError("ShardProfile needs layout='csr' (padded shapes "
                         "are already content-dependent per worker)")
    if meta["split"]:
        raise ValueError("ShardProfile does not support balance='split': "
                         "physical shard bounds are static meta, not "
                         "paddable arrays")
    if meta["hier"]:
        raise ValueError("ShardProfile supports the 1-D mesh only")
    if meta["plan_meta"]:
        raise ValueError("ShardProfile supports plan_kinds=() (dense "
                         "backend) only")


def shard_profile(pg, devices, slack: float = 1.25,
                  pad: int = 8) -> ShardProfile:
    """Measure ``pg``'s natural shard shapes and inflate them by ``slack``
    (rounded up to ``pad`` lanes) into a frozen envelope with mutation
    headroom."""
    D, _ = _normalize_devices(devices)
    meta, arrays = _shard_graph(pg, devices, (), 0)
    _profile_supported(meta)

    def up(x):
        return int(-(-int(np.ceil(x * slack)) // pad) * pad)

    fm = meta["fetch_meta"]["mir"]
    hint = meta["cap_hint"]
    return ShardProfile(
        D=D,
        eg_cap=up(arrays["eg_src"].shape[1]),
        all_cap=up(arrays["all_src"].shape[1]),
        mir_cap=up(arrays["mir_esrc"].shape[1]),
        n_mir=up(arrays["mir_ids"].shape[0]),
        fetch_cap=up(fm["cap"]), fetch_need=up(fm["n_need"]),
        cap_hint=None if hint is None else up(hint))


def _pad_cols(a, cap, pad_col, what):
    """(D, c) -> (D, cap) padded with the per-device column ``pad_col``."""
    a = np.asarray(a)
    d, c = a.shape
    if c > cap:
        raise ProfileOverflow(f"{what}: {c} rows exceed the frozen "
                              f"profile cap {cap}")
    if c == cap:
        return a
    pad = np.broadcast_to(np.asarray(pad_col, a.dtype).reshape(d, 1),
                          (d, cap - c)).copy()
    return np.concatenate([a, pad], axis=1)


def _apply_profile(meta, arrays, prof: ShardProfile) -> None:
    """Re-pad freshly sharded host ``arrays`` (and the content-dependent
    meta) to the frozen envelope, in place."""
    _profile_supported(meta)
    D, m, n_loc = meta["D"], meta["m_loc"], meta["n_loc"]
    if D != prof.D:
        raise ProfileOverflow(f"profile built for D={prof.D}, got D={D}")
    base = np.arange(D) * m * n_loc
    zero = np.zeros(D)
    for name, cap in (("eg", prof.eg_cap), ("all", prof.all_cap)):
        arrays[f"{name}_src"] = _pad_cols(arrays[f"{name}_src"], cap,
                                          base, f"{name}_src")
        for k in ("dst", "w", "mask"):
            arrays[f"{name}_{k}"] = _pad_cols(arrays[f"{name}_{k}"], cap,
                                              zero, f"{name}_{k}")
    for k, pad_col in (("esrc", zero), ("edst", base), ("ew", zero),
                       ("emask", zero), ("cesrc", zero)):
        arrays[f"mir_{k}"] = _pad_cols(arrays[f"mir_{k}"], prof.mir_cap,
                                       pad_col, f"mir_{k}")
    # replicated mirror tables: sentinel-padded ids (n_pad: inert in every
    # need list and value gather), zero extra workers
    ids = np.asarray(arrays["mir_ids"])
    if len(ids) > prof.n_mir:
        raise ProfileOverflow(f"n_mir {len(ids)} exceeds the frozen "
                              f"profile {prof.n_mir}")
    sent = np.full(prof.n_mir - len(ids), meta["M"] * n_loc, ids.dtype)
    arrays["mir_ids"] = np.concatenate([ids, sent])
    nw = np.asarray(arrays["mir_nworkers"])
    arrays["mir_nworkers"] = np.concatenate(
        [nw, np.zeros(prof.n_mir - len(nw), nw.dtype)])
    # mirror fetch plan: -1 lanes are dropped by _fetch_planned; a larger
    # n_need only grows the compact buffer (real positions untouched)
    fm = meta["fetch_meta"]["mir"]
    if fm["cap"] > prof.fetch_cap or fm["n_need"] > prof.fetch_need:
        raise ProfileOverflow(
            f"mirror fetch plan (cap {fm['cap']}, n_need {fm['n_need']}) "
            f"exceeds the frozen profile (cap {prof.fetch_cap}, n_need "
            f"{prof.fetch_need})")
    for k in ("send_slot", "recv_pos"):
        a = np.asarray(arrays[f"fetch_mir_{k}"])
        out = np.full(a.shape[:2] + (prof.fetch_cap,), -1, a.dtype)
        out[:, :, :a.shape[2]] = a
        arrays[f"fetch_mir_{k}"] = out
    meta["fetch_meta"]["mir"] = {"cap": prof.fetch_cap,
                                 "n_need": prof.fetch_need}
    meta["cap_hint"] = prof.cap_hint


def reshard_arrays(pg, devices, profile: ShardProfile) -> Dict:
    """The host tables of ``pg`` over ``devices``, padded to ``profile``
    (what ``reshard`` writes into a resident ShardedGraph)."""
    meta, arrays = _shard_graph(pg, devices, (), 0)
    _apply_profile(meta, arrays, profile)
    return arrays


# ---------------------------------------------------------------------------
# the device-local graph view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardPlan:
    """One rank's slice of a stacked message plan, on its device (the
    reference's ``TracedPlan``).  Row and segment counts are the maxima
    over devices.  The pipeline's chunk tables (``crow*``, ``cx*``,
    ``cr*``) and the 2-D mesh's two-leg tables (``x1*``, ``iscat``,
    ``x2*``, ``r2*``) are None where the run has no use for them."""
    nb: int
    eb: int
    B_per_w: int
    n_rows: int
    n_segs: int
    xcap: int
    row_gather: torch.Tensor   # (n_rows, eb) int64 -> local flat edge
    row_valid: torch.Tensor    # (n_rows, eb) bool
    row_local: torch.Tensor    # (n_rows, eb) int32, the kernel's idx
    row_seg: torch.Tensor      # (n_rows,) int64
    seg_blk: torch.Tensor      # (n_segs,) int64 global block
    seg_worker: torch.Tensor   # (n_segs,) int64 global source worker/shard
    xseg: torch.Tensor         # (D, xcap) int64 my segment per dest device
    xval: torch.Tensor         # (D, xcap) bool
    rblk: torch.Tensor         # (D, xcap) int64 local block per source
    rval: torch.Tensor         # (D, xcap) bool
    # the pipeline's chunk tables
    n_chunks: int = 1
    ccap: int = 0                            # exchange lanes a chunk
    cr: int = 0                              # most rows a chunk
    cs: int = 0                              # most segments a chunk
    crow: Optional[torch.Tensor] = None      # (C, cr) row index
    crow_ok: Optional[torch.Tensor] = None   # (C, cr)
    crow_seg: Optional[torch.Tensor] = None  # (C, cr) chunk-local segment
    cxseg: Optional[torch.Tensor] = None     # (C, D, ccap) chunk-local send
    cxval: Optional[torch.Tensor] = None     # (C, D, ccap)
    crblk: Optional[torch.Tensor] = None     # (C, D, ccap) local dst block
    crval: Optional[torch.Tensor] = None     # (C, D, ccap)
    # the 2-D mesh's two-leg tables
    x1cap: int = 0
    n_iseg: int = 0                          # intermediate segments
    x2cap: int = 0
    hchunks: int = 1                         # inter-host pipeline chunks
    x1seg: Optional[torch.Tensor] = None     # (T, x1cap) my seg per column
    x1val: Optional[torch.Tensor] = None
    iscat: Optional[torch.Tensor] = None     # (T, x1cap) recv -> inter seg
    ival: Optional[torch.Tensor] = None
    x2seg: Optional[torch.Tensor] = None     # (H, x2cap) inter seg per host
    x2val: Optional[torch.Tensor] = None
    r2blk: Optional[torch.Tensor] = None     # (H, x2cap) local dst block
    r2val: Optional[torch.Tensor] = None
    # the feature-blocked combine's tables, built by ``vec_build`` when a
    # feature-blocked payload first needs them (``vec_plan``)
    vec: Optional["VecPlan"] = None
    vec_build: Optional[Callable] = dataclasses.field(default=None,
                                                      repr=False)

    def vec_plan(self) -> "VecPlan":
        if self.vec is None:
            self.vec = self.vec_build(self)
            self.vec_build = None
        return self.vec


@dataclasses.dataclass
class ShardFetch:
    """One rank's slice of a static fetch plan (the reference's
    ``TracedFetch``): flat tables on a 1-D mesh, the gateway's two legs
    (``a_*`` over the column group, ``b_*`` over the host group) on the
    2-D mesh."""
    n_need: int
    cap: int = 0
    send_slot: Optional[torch.Tensor] = None  # (D, cap) LOCAL slot, -1 pad
    recv_pos: Optional[torch.Tensor] = None   # (D, cap) compact pos, -1 pad
    n_gw: int = 0
    cap_a: int = 0
    cap_b: int = 0
    a_send: Optional[torch.Tensor] = None     # (H, cap_a) LOCAL slot, -1
    a_recv: Optional[torch.Tensor] = None     # (H, cap_a) gateway pos, -1
    b_send: Optional[torch.Tensor] = None     # (T, cap_b) gateway pos, -1
    b_recv: Optional[torch.Tensor] = None     # (T, cap_b) compact pos, -1


class _InFlight:
    """An ``all_to_all`` issued with ``async_op=True``: holds the send
    buffer until ``wait()`` so that the caching allocator cannot hand its
    memory to another tensor while the collective still reads it."""

    def __init__(self, out: torch.Tensor, send: torch.Tensor, work):
        self.out, self.send, self.work = out, send, work

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        self.send = self.work = None
        return self.out


@dataclasses.dataclass
class ShardedGraph:
    """One rank's view of a PartitionedGraph: ``M``/``n_loc`` stay
    *global* (owner arithmetic, per-worker stats), the vertex rows and
    edge arrays are this rank's, and the ``g*`` reductions are
    collectives.  The channels see ``sharded`` and route to the
    implementations below.

    ``T > 0`` selects the 2-D mesh's hierarchical exchanges over
    ``group_w`` (this rank's host group, size T) and ``group_h`` (its
    column group, size H).  ``split`` marks a split partition: ``*_pw``
    hold the edges' physical shards, ``*_csrc`` their source values'
    positions in the fetched compact arrays.

    ``rounds`` and ``host_reads`` record, for the run at hand, the
    exchange rounds of each routed join (inner legs included, which
    ``inner_rounds`` also lists) and the host reads they made."""
    M: int
    n_loc: int
    m_loc: int
    D: int
    rank: int
    n: int
    tau: int
    layout: str
    device: torch.device
    vmask: torch.Tensor
    deg: torch.Tensor
    eg_src: torch.Tensor
    eg_dst: torch.Tensor
    eg_mask: torch.Tensor
    eg_w: torch.Tensor
    all_src: torch.Tensor
    all_dst: torch.Tensor
    all_mask: torch.Tensor
    all_w: torch.Tensor
    mir_ids: torch.Tensor
    mir_nworkers: torch.Tensor
    mir_esrc: torch.Tensor
    mir_edst: torch.Tensor
    mir_emask: torch.Tensor
    mir_ew: torch.Tensor
    mir_cesrc: torch.Tensor    # mirror edge -> index into the fetched values
    fetch: Dict[str, ShardFetch]
    plans: Dict[str, ShardPlan] = dataclasses.field(default_factory=dict)
    cap_hint: Optional[int] = None
    # the 2-D mesh
    H: int = 1
    T: int = 0
    cap_hint_w: Optional[int] = None
    cap_hint_h: Optional[int] = None
    group_w: object = None
    group_h: object = None
    # the pipeline
    pipeline: bool = False
    pipeline_chunks: int = 1
    # split partitions
    split: bool = False
    M_phys: int = 0
    P_loc: int = 0
    p0: int = 0                                 # first shard of this rank
    phys_log: Optional[torch.Tensor] = None     # (M_phys,) replicated
    eg_pw: Optional[torch.Tensor] = None
    all_pw: Optional[torch.Tensor] = None
    mir_pw: Optional[torch.Tensor] = None
    eg_csrc: Optional[torch.Tensor] = None
    all_csrc: Optional[torch.Tensor] = None
    build_s: float = 0.0                 # host seconds of the table build
    rounds: List[int] = dataclasses.field(default_factory=list)
    inner_rounds: List[int] = dataclasses.field(default_factory=list)
    host_reads: int = 0
    sharded = True

    @property
    def n_pad(self) -> int:
        return self.M * self.n_loc

    @property
    def hier(self) -> bool:
        return self.T > 0

    @property
    def w0(self) -> int:
        """Global index of this rank's first worker."""
        return self.rank * self.m_loc

    def reset_counts(self) -> None:
        """Start the per-run records (rounds, host reads) afresh."""
        self.rounds = []
        self.inner_rounds = []
        self.host_reads = 0

    def table_bytes(self) -> int:
        """Device bytes of this rank's tables (edges, fetch and plans)."""
        tensors = [v for v in vars(self).values()
                   if isinstance(v, torch.Tensor)]
        for p in list(self.plans.values()) + list(self.fetch.values()):
            tensors += [v for v in vars(p).values()
                        if isinstance(v, torch.Tensor)]
        for vp in [p.vec for p in self.plans.values() if p.vec is not None]:
            for v in vars(vp).values():
                # a view of the plan's own tables is counted there
                tensors += [t for t in (v if isinstance(v, list) else [v])
                            if isinstance(t, torch.Tensor) and t._base is None]
        return sum(t.numel() * t.element_size() for t in tensors)

    def local_ids(self) -> torch.Tensor:
        """(m_loc, n_loc) int64 global id of each local slot."""
        return torch.arange(self.w0 * self.n_loc,
                            (self.w0 + self.m_loc) * self.n_loc,
                            device=self.device).view(self.m_loc, self.n_loc)

    def worker_ids(self) -> torch.Tensor:
        """(m_loc,) global worker indices of the local rows."""
        return torch.arange(self.w0, self.w0 + self.m_loc,
                            device=self.device)

    def log_of(self, worker: torch.Tensor) -> torch.Tensor:
        """Physical shard ids -> logical workers (the identity when the
        partition is not split)."""
        return self.phys_log[worker.long()] if self.split else worker.long()

    # -- collectives --------------------------------------------------------
    def all_to_all(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """Block k of axis 0 goes to rank k of ``group`` (default: the
        whole group); block s of the result came from its rank s
        (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    def start(self, x: torch.Tensor, group=None) -> _InFlight:
        """``all_to_all`` issued asynchronously under the pipeline, and
        at once without it; ``wait()`` on the result gives the received
        buffer."""
        if not self.pipeline:
            return _InFlight(self.all_to_all(x, group), None, None)
        send = x.contiguous()
        out = torch.empty_like(send)
        work = dist.all_to_all_single(out, send, group=group, async_op=True)
        return _InFlight(out, send, work)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """In-place all-reduce of ``x`` (a number tensor) over the whole
        default group."""
        dist.all_reduce(x, op=op)
        return x

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``x`` along axis 0, in rank order;
        bools travel as uint8."""
        y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(y) for _ in range(self.D)]
        dist.all_gather(parts, y)
        out = torch.cat(parts)
        return out > 0 if x.dtype == torch.bool else out

    def read_int(self, x: torch.Tensor) -> int:
        """One host read of a replicated device scalar."""
        self.host_reads += 1
        return int(x)

    def gany(self, x: torch.Tensor) -> torch.Tensor:
        t = x.any().to(torch.int32).reshape(1)
        return self.all_reduce(t)[0] > 0

    def gall(self, x: torch.Tensor) -> torch.Tensor:
        t = (~x.all()).to(torch.int32).reshape(1)
        return self.all_reduce(t)[0] == 0

    def gsum(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x.sum().reshape(1))[0]

    def gmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x.max().reshape(1), dist.ReduceOp.MAX)[0]

    def edge_src_values(self, state: torch.Tensor, src: torch.Tensor,
                        kind: Optional[str] = None) -> torch.Tensor:
        """``state`` at each local edge's source: ``src`` holds global
        slot ids in csr (this rank's, or under a split partition any
        rank's), local slots in padded rows.  ``kind`` names the edge set
        ``src`` belongs to, ``"all"`` or ``"eg"``: a split partition reads
        the sources through that set's static fetch plan."""
        if self.layout != "csr":
            return torch.gather(state, 1, src.long())
        if not self.split:
            return state.reshape(-1)[src.long() - self.w0 * self.n_loc]
        if kind not in ("all", "eg"):
            raise ValueError("a split partition reads edge sources through "
                             "a planned edge set: pass kind='all' or 'eg', "
                             f"not {kind!r}")
        vals = _fetch_planned(self, self.fetch[kind], state.reshape(-1), 0)
        return vals[getattr(self, f"{kind}_csrc")]


_REPLICATED = ("mir_ids", "mir_nworkers", "phys_log")


def _slice(meta, arrays, name: str, rank: int) -> np.ndarray:
    """This rank's part of one host table of ``_shard_graph``."""
    m = meta["m_loc"]
    a = arrays[name]
    if name in _REPLICATED:
        return a
    if name in ("vmask", "deg") or (meta["layout"] != "csr"
                                    and name != "mir_cesrc"):
        return a[rank * m:(rank + 1) * m]            # worker rows
    return a[rank]                                   # device-stacked


def _upload(a: np.ndarray, device, long: bool = False) -> torch.Tensor:
    """``a`` on ``device``; index arrays (``long``) as int64."""
    a = np.ascontiguousarray(a, dtype=np.int64 if long else None)
    return torch.as_tensor(a, device=device)


#: the plan tables of each optional group: (meta keys, index arrays, masks)
_CHUNK_TABLES = (("n_chunks", "ccap", "cr", "cs"),
                 ("crow", "crow_seg", "cxseg", "crblk"),
                 ("crow_ok", "cxval", "crval"))
_HIER_TABLES = (("x1cap", "n_iseg", "x2cap", "hchunks"),
                ("x1seg", "iscat", "x2seg", "r2blk"),
                ("x1val", "ival", "x2val", "r2val"))


@dataclasses.dataclass
class VecPlan:
    """One rank's tables of the feature-blocked plan combine, derived from
    its stacked plan.  The combine writes into one *work* buffer of
    ``n_work`` (nb, F) blocks: my ``m_loc*B_per_w`` local blocks first,
    then the send slots of the segments that leave this rank, then one
    dump block (dummy segments).  Each row merges straight into its
    segment's block (``row_dst``), so the segment partials exist only for
    segments that leave the rank, in the buffer the exchange sends; at
    D=1 nothing leaves it.  1-D mesh: ``xcr`` slots a destination rank;
    the receive side is the plan's own ``rblk``/``rval`` (views, cut to
    ``xcr`` lanes; ``peers`` masks my own row); under the pipeline ``ccr``
    a chunk and destination (views of ``crblk``/``crval``), the chunks'
    rows ``crows``.  2-D
    mesh: leg 1 carries my segments that leave me, compacted
    (``x1cr``; ``iscat``/``ival`` into the intermediate buffer of
    ``n_ibuf`` blocks, only those that receive lanes, plus a dump);
    intermediate segments of my own blocks go straight to my blocks
    (``self_iseg`` -> ``self_blk``); leg 2 carries the rest (``x2cr``).
    Every cap is the maximum over the ranks, so the ``all_to_all``
    splits agree."""
    n_work: int
    row_dst: torch.Tensor                     # (n_rows,) work block of a row
    peers: Optional[torch.Tensor] = None      # (D, 1) bool, not my row
    xcr: int = 0
    rblk: Optional[torch.Tensor] = None       # (D, xcr) view of the plan's
    rval: Optional[torch.Tensor] = None
    ccr: int = 0
    crows: Optional[List[torch.Tensor]] = None
    crblk: Optional[torch.Tensor] = None      # (C, D, ccr) views
    crval: Optional[torch.Tensor] = None
    x1cr: int = 0
    iscat: Optional[torch.Tensor] = None      # (T, x1cr) -> intermediate
    ival: Optional[torch.Tensor] = None
    n_ibuf: int = 1
    self_iseg: Optional[torch.Tensor] = None  # intermediate segments of mine
    self_blk: Optional[torch.Tensor] = None   # ... and their local blocks
    x2cr: int = 0
    x2seg: Optional[torch.Tensor] = None      # (H, x2cr) intermediate
    x2val: Optional[torch.Tensor] = None
    r2blk: Optional[torch.Tensor] = None      # (H, x2cr) local block
    r2val: Optional[torch.Tensor] = None


#: the stacked plan tables ``_vec_tables`` reads (not the (rows, eb) ones)
_VEC_INPUTS = ("seg_blk", "row_seg", "xseg", "xval", "x1seg", "x1val",
               "iscat", "ival", "x2seg", "x2val", "r2blk", "r2val")


def _vec_tables(pm, arrays, kind: str, rank: int, m_loc: int, hier
                ) -> dict:
    """Host numpy fields of one rank's ``VecPlan`` that the plan does not
    hold, from the stacked tables of ``_stack_plans`` (every rank's: the
    caps are the maxima over the ranks).  A segment is *mine* when its
    block is; every other real segment gets a send slot in the position
    order of the stacked exchange lists."""
    def a(k):
        return arrays[f"plan_{kind}_{k}"]
    bpd = m_loc * pm["B_per_w"]
    seg_blk = a("seg_blk")[rank].astype(np.int64)
    seg_dst = np.full(len(seg_blk), -1, np.int64)
    out = {}
    if hier is None:
        xseg, xval = a("xseg"), a("xval")
        D = xseg.shape[0]
        cnt = xval.sum(axis=2)
        xcr = int((cnt - np.diag(np.diag(cnt))).max())
        own = xseg[rank, rank][xval[rank, rank]]
        seg_dst[own] = seg_blk[own] - rank * bpd
        chunked = "n_chunks" in pm
        C, ccap = ((pm["n_chunks"], pm["ccap"]) if chunked
                   else (1, max(xcr, 1)))
        ccr = min(ccap, xcr)
        for d2 in range(D):
            if d2 != rank:
                sel = xseg[rank, d2][xval[rank, d2]]
                j = np.arange(len(sel))
                seg_dst[sel] = (bpd + (j // ccap) * D * ccr + d2 * ccr
                                + j % ccap)
        n_send = C * D * ccr
        out.update(xcr=xcr, ccr=ccr if chunked else 0)
    else:
        H, T = hier
        D = H * T
        h, t = divmod(rank, T)
        x1seg, x1val = a("x1seg"), a("x1val")

        def leaves(d):
            """Device d's segments bound for its own column (leg 1 to
            itself), as positions of that list: True where the segment
            is not d's own, and so crosses hosts after the
            intermediate combine."""
            sel = x1seg[d, d % T][x1val[d, d % T]]
            return a("seg_blk")[d][sel] // bpd != d
        x1cr = 0
        for d in range(D):
            c1 = x1val[d].sum(axis=1)
            c1[d % T] = leaves(d).sum()
            x1cr = max(x1cr, int(c1.max()))
        keep = leaves(rank)
        for t2 in range(T):
            sel = x1seg[rank, t2][x1val[rank, t2]]
            if t2 == t:
                mine = sel[~keep]
                seg_dst[mine] = seg_blk[mine] - rank * bpd
                sel = sel[keep]
            seg_dst[sel] = bpd + t2 * x1cr + np.arange(len(sel))
        n_send = T * x1cr
        iscat, ival = a("iscat")[rank], a("ival")[rank]
        viscat = np.zeros((T, x1cr), np.int64)
        vival = np.zeros((T, x1cr), bool)
        for t1 in range(T):
            pos = np.flatnonzero(ival[t1])
            if t1 == t:
                pos = pos[keep]
            viscat[t1, :len(pos)] = iscat[t1, pos]
            vival[t1, :len(pos)] = True
        need = np.unique(viscat[vival])
        imap = np.full(pm["n_iseg"], len(need), np.int64)
        imap[need] = np.arange(len(need))
        c2 = a("x2val").sum(axis=2)                    # (D, H)
        c2[np.arange(D), np.arange(D) // T] = 0        # the self pair
        x2cr = int(c2.max())
        x2seg, x2val = a("x2seg")[rank], a("x2val")[rank]
        n_self = int(x2val[h].sum())
        vx2val = x2val[:, :x2cr].copy()
        vx2val[h] = False
        vr2val = a("r2val")[rank][:, :x2cr].copy()
        vr2val[h] = False
        out.update(x1cr=x1cr, iscat=imap[viscat], ival=vival,
                   n_ibuf=len(need) + 1,
                   self_iseg=imap[x2seg[h, :n_self]],
                   self_blk=a("r2blk")[rank][h, :n_self],
                   x2cr=x2cr, x2seg=imap[x2seg[:, :x2cr]], x2val=vx2val,
                   r2blk=a("r2blk")[rank][:, :x2cr], r2val=vr2val)
    n_work = bpd + n_send + 1
    seg_dst[seg_dst < 0] = n_work - 1
    out.update(n_work=n_work, row_dst=seg_dst[a("row_seg")[rank]])
    return out


def _vec_builder(pm, arrays, kind: str, rank: int, m_loc: int, hier
                 ) -> Callable:
    """``ShardPlan.vec_build``: makes this rank's ``VecPlan`` beside the
    plan, keeping until then only the stacked tables it reads."""
    keep = {k: v for k, v in arrays.items()
            if k.startswith(f"plan_{kind}_")
            and k[len(f"plan_{kind}_"):] in _VEC_INPUTS}

    def build(plan: ShardPlan) -> VecPlan:
        f = _vec_tables(pm, keep, kind, rank, m_loc, hier)
        device = plan.row_seg.device
        for k, v in f.items():
            if isinstance(v, np.ndarray):
                f[k] = _upload(v, device, long=v.dtype != bool)
        if hier is None:
            D = plan.xseg.shape[0]
            f["peers"] = (torch.arange(D, device=device) != rank)[:, None]
            if f["ccr"]:
                f.update(crows=[plan.crow[c][plan.crow_ok[c]]
                                for c in range(plan.n_chunks)],
                         crblk=plan.crblk[..., :f["ccr"]],
                         crval=plan.crval[..., :f["ccr"]])
            else:
                f.update(rblk=plan.rblk[:, :f["xcr"]],
                         rval=plan.rval[:, :f["xcr"]])
        return VecPlan(**f)
    return build


def _make_plan(meta, arrays, kind: str, rank: int, device) -> ShardPlan:
    pm = meta["plan_meta"][kind]

    def part(k, long=False):
        return _upload(arrays[f"plan_{kind}_{k}"][rank], device, long)
    extra = {}
    for keys, index, masks in (_CHUNK_TABLES, _HIER_TABLES):
        if keys[0] in pm:
            extra.update({k: pm[k] for k in keys})
            extra.update({k: part(k, long=True) for k in index})
            extra.update({k: part(k) for k in masks})
    return ShardPlan(
        nb=pm["nb"], eb=pm["eb"], B_per_w=pm["B_per_w"],
        n_rows=pm["n_rows"], n_segs=pm["n_segs"], xcap=pm["xcap"],
        row_gather=part("row_gather", long=True),
        row_valid=part("row_valid"), row_local=part("row_local"),
        row_seg=part("row_seg", long=True),
        seg_blk=part("seg_blk", long=True),
        seg_worker=part("seg_worker", long=True),
        xseg=part("xseg", long=True), xval=part("xval"),
        rblk=part("rblk", long=True), rval=part("rval"),
        vec_build=_vec_builder(pm, arrays, kind, rank, meta["m_loc"],
                               meta["hier"]), **extra)


def _make_fetch(fm, arrays, name: str, rank: int, device) -> ShardFetch:
    def part(k):
        return _upload(arrays[f"fetch_{name}_{k}"][rank], device, long=True)
    if "n_gw" in fm:
        return ShardFetch(n_need=fm["n_need"], n_gw=fm["n_gw"],
                          cap_a=fm["cap_a"], cap_b=fm["cap_b"],
                          a_send=part("a_send"), a_recv=part("a_recv"),
                          b_send=part("b_send"), b_recv=part("b_recv"))
    return ShardFetch(n_need=fm["n_need"], cap=fm["cap"],
                      send_slot=part("send_slot"), recv_pos=part("recv_pos"))


def _make_sg(meta, arrays, rank: int, device) -> ShardedGraph:
    """Move this rank's slice of the host tables to ``device``."""
    def loc(name, long=False):
        return _upload(_slice(meta, arrays, name, rank), device, long)

    mir_esrc = loc("mir_esrc")
    cesrc = loc("mir_cesrc", long=True).reshape(mir_esrc.shape)
    extra = {}
    if meta["hier"]:
        extra.update(H=meta["hier"][0], T=meta["hier"][1],
                     cap_hint_w=meta["cap_hint_w"],
                     cap_hint_h=meta["cap_hint_h"])
    if meta["split"]:
        extra.update(split=True, M_phys=meta["M_phys"], P_loc=meta["P_loc"],
                     p0=int(meta["p_bounds"][rank]),
                     phys_log=loc("phys_log", long=True),
                     **{f"{k}_pw": loc(f"{k}_pw", long=True)
                        for k in ("eg", "all", "mir")},
                     **{f"{k}_csrc": loc(f"{k}_csrc", long=True)
                        for k in ("eg", "all")})
    return ShardedGraph(
        M=meta["M"], n_loc=meta["n_loc"], m_loc=meta["m_loc"],
        D=meta["D"], rank=rank, n=meta["n"], tau=meta["tau"],
        layout=meta["layout"], device=torch.device(device),
        vmask=loc("vmask"), deg=loc("deg"),
        eg_src=loc("eg_src"), eg_dst=loc("eg_dst"), eg_mask=loc("eg_mask"),
        eg_w=loc("eg_w"), all_src=loc("all_src"), all_dst=loc("all_dst"),
        all_mask=loc("all_mask"), all_w=loc("all_w"),
        mir_ids=loc("mir_ids"), mir_nworkers=loc("mir_nworkers"),
        mir_esrc=mir_esrc, mir_edst=loc("mir_edst"),
        mir_emask=loc("mir_emask"), mir_ew=loc("mir_ew"), mir_cesrc=cesrc,
        fetch={name: _make_fetch(fm, arrays, name, rank, device)
               for name, fm in meta["fetch_meta"].items()},
        plans={k: _make_plan(meta, arrays, k, rank, device)
               for k in meta["plan_meta"]},
        cap_hint=meta["cap_hint"], pipeline=meta["pipeline"],
        pipeline_chunks=meta["pipeline_chunks"], **extra)


# ---------------------------------------------------------------------------
# the process group, and the per-partition cache of shard views
# ---------------------------------------------------------------------------

def world(M: Optional[int], devices, device) -> tuple:
    """``(D, rank)`` of the default process group, after checking that it
    matches ``devices`` (D ranks, or H*T for an ``(H, T)`` mesh) and
    divides ``M`` workers (no fallback: a missing or mismatched group
    raises)."""
    D, _ = _normalize_devices(devices)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"devices={devices!r} runs one process per device over "
            "torch.distributed: call torch.distributed.init_process_group"
            f"(backend, init_method, world_size={D}, rank=r) in each of "
            f"{D} processes first (NCCL between GPUs, one GPU a rank; gloo "
            "between CPU processes), or launch them with "
            f"`python -m repro_torch.launch.graph_run --devices {D}`")
    size = dist.get_world_size()
    if size != D:
        raise RuntimeError(f"devices={devices!r} needs {D} ranks, but the "
                           f"default process group has world size {size}")
    if M is not None and M % D:
        raise ValueError(f"M={M} workers must divide over devices={D}")
    dev = torch.device(device)
    if dist.get_backend() == "nccl":
        if dev.type != "cuda":
            raise RuntimeError(f"an NCCL group exchanges CUDA tensors; this "
                               f"rank runs on {dev}")
        if D > torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL puts one GPU under each rank: {D} ranks, "
                f"{torch.cuda.device_count()} GPUs visible")
    return D, dist.get_rank()


def shard(pg, devices, plan_kinds: Sequence[str] = (), device=None,
          pipeline: bool = False, pipeline_chunks: Optional[int] = None,
          profile: Optional[ShardProfile] = None) -> ShardedGraph:
    """This rank's ShardedGraph of ``pg`` on ``device`` (default: the
    partition's device), with the message plans of ``plan_kinds``.  Built
    once per (mesh, rank, device, pipeline, profile) and cached on ``pg``;
    the plans of a kind are added when first asked for.  On an ``(H, T)``
    mesh the host and column subgroups come from ``launch.mesh``.  Only
    ``pg``'s host tables are read.  ``profile`` pads the tables to a
    frozen envelope (csr, 1-D mesh, no plans; ``ProfileOverflow`` when
    they do not fit), which ``reshard`` can later refill in place."""
    device = torch.device(pg.device if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    D, rank = world(pg.M, devices, device)
    _, hier = _normalize_devices(devices)
    nb = planlib.default_nb(device)
    chunks = _chunks_of(D, pipeline, pipeline_chunks)
    key = ("shard", hier or D, rank, str(device), nb, chunks, profile)
    sg = pg.plan_cache.get(key)
    t0 = time.perf_counter()
    if sg is None:
        meta, arrays = _shard_graph(pg, devices, plan_kinds, nb, pipeline,
                                    pipeline_chunks)
        if profile is not None:
            _apply_profile(meta, arrays, profile)
        sg = pg.plan_cache[key] = _make_sg(meta, arrays, rank, device)
        sg.build_s = time.perf_counter() - t0
    for kind in [k for k in plan_kinds if k not in sg.plans]:
        t0 = time.perf_counter()
        pmeta, arrays = _stacked_plan(pg, devices, kind, nb, chunks)
        sg.plans[kind] = _make_plan(
            {"plan_meta": {kind: pmeta}, "m_loc": sg.m_loc,
             "hier": hier}, arrays, kind, rank, device)
        sg.build_s += time.perf_counter() - t0
    if hier:
        sg.group_w, sg.group_h = meshlib.graph_mesh(*hier)
    sg.reset_counts()
    return sg


def _tensors(sg: ShardedGraph):
    """(name, tensor) of every table of a ShardedGraph built without
    message plans, its fetch plans' included."""
    for f in dataclasses.fields(sg):
        v = getattr(sg, f.name)
        if isinstance(v, torch.Tensor):
            yield f.name, v
    for name, fp in sorted(sg.fetch.items()):
        for f in dataclasses.fields(fp):
            v = getattr(fp, f.name)
            if isinstance(v, torch.Tensor):
                yield f"fetch_{name}.{f.name}", v


def reshard(sg: ShardedGraph, pg, profile: ShardProfile) -> None:
    """Write ``pg``'s tables, padded to ``profile``, into this rank's
    resident ShardedGraph ``sg`` in place: the same tensors, shapes and
    storage, so a step function built on ``sg`` runs on the new graph.
    ``pg`` is a fold of the graph ``sg`` was built from, or a new
    partition of it over the same workers; ``sg`` was built under the same
    profile.  Raises ``ProfileOverflow`` (and leaves ``sg`` as it was)
    when the tables outgrow the envelope."""
    if (pg.M, pg.n_loc) != (sg.M, sg.n_loc):
        raise ProfileOverflow(f"(M, n_loc) {(pg.M, pg.n_loc)} is not the "
                              f"resident graph's {(sg.M, sg.n_loc)}")
    t0 = time.perf_counter()
    meta, arrays = _shard_graph(pg, sg.D, (), 0)
    _apply_profile(meta, arrays, profile)
    fresh = dict(_tensors(_make_sg(meta, arrays, sg.rank, "cpu")))
    old = dict(_tensors(sg))
    if sorted(fresh) != sorted(old):
        raise ProfileOverflow(f"tables {sorted(fresh)} are not the resident "
                              f"graph's {sorted(old)}")
    for name, t in old.items():
        if fresh[name].shape != t.shape or fresh[name].dtype != t.dtype:
            raise ProfileOverflow(
                f"{name}: {tuple(fresh[name].shape)} {fresh[name].dtype} "
                f"does not fit the resident {tuple(t.shape)} {t.dtype}")
    for name, t in old.items():
        t.copy_(fresh[name])
    sg.tau = meta["tau"]          # the cap hint and fetch sizes are frozen
    sg.build_s += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# routed exchange cores
# ---------------------------------------------------------------------------

def _place_rows(sg: ShardedGraph, local_counts: torch.Tensor
                ) -> torch.Tensor:
    """(m_loc,) per-local-worker counts -> this rank's (M,) partial."""
    full = torch.zeros(sg.M, dtype=torch.int64, device=sg.device)
    full[sg.w0:sg.w0 + sg.m_loc] = local_counts
    return full


def _bucket(sg: ShardedGraph, targets, valid, level: Optional[str] = None):
    """Sort lanes by a coordinate of their destination device, invalid
    last: the device itself (``level`` None, 1-D mesh), its column within
    the host (``"w"``) or its host (``"h"``).  Returns (order, (K+1,)
    bucket offsets), K the number of buckets.  The target is clamped
    before the owner division, as the reference clips it."""
    loc_n = sg.m_loc * sg.n_loc
    dd = torch.div(targets.clamp(0, sg.n_pad - 1), loc_n,
                   rounding_mode="floor")
    if level is None:
        K, coord = sg.D, dd
    elif level == "w":
        K, coord = sg.T, dd % sg.T
    else:
        K, coord = sg.H, torch.div(dd, sg.T, rounding_mode="floor")
    key = torch.where(valid, coord, K).to(torch.int32)   # 32-bit sort keys
    order = torch.argsort(key, stable=True)
    off = torch.searchsorted(key[order], torch.arange(
        K + 1, dtype=torch.int32, device=sg.device))
    return order, off


def _rounds_for(sg: ShardedGraph, off: torch.Tensor, cap: int,
                inner: bool = False) -> int:
    """The number of ``all_to_all`` rounds of one routed join (or, with
    ``inner``, of one inter-host leg of the 2-D mesh), all-reduced over
    the whole default group and read on the host once: balanced traffic
    fits the cap in one round, a hot destination adds rounds."""
    counts = off[1:] - off[:-1]
    r = ((counts + cap - 1) // cap).max().reshape(1)
    rounds = sg.read_int(sg.all_reduce(r, dist.ReduceOp.MAX)[0])
    sg.rounds.append(rounds)
    if inner:
        sg.inner_rounds.append(rounds)
    return rounds


def _round_lanes(off: torch.Tensor, r: int, cap: int, L: int):
    """Round ``r``'s (K, cap) lane window into the bucket-sorted arrays:
    per bucket the slice [off[k] + r*cap, off[k+1]) clipped to ``cap``
    lanes.  Returns (indices, in-bucket validity).  The indices are
    clamped into [0, L]: the sorted arrays carry one sentinel lane at L,
    so a rank with no lanes (L = 0) still reads in bounds, where the
    reference's ``clip(idx, 0, L - 1)`` would give -1."""
    idx = (off[:-1, None] + r * cap
           + torch.arange(cap, device=off.device)[None])
    ok = idx < off[1:, None]
    return idx.clamp(0, L), ok


def _with_sentinel(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` with one more lane (or (F,) row) of ``fill`` at its end."""
    return torch.cat([x, torch.full((1,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def _feat_elems(feat: tuple) -> int:
    e = 1
    for s in feat:
        e *= int(s)
    return e


def _pipeline_cap(sg: ShardedGraph, cap: int, feat_elems: int = 1) -> int:
    """Shrink a routed-exchange round cap so that one join spans about
    ``sg.pipeline_chunks`` rounds, the chunks the double buffer overlaps.
    It only shrinks (an explicit small cap passes through).  A
    feature-blocked payload shrinks it further by its width
    (``feat_elems`` values a lane), so the two buffers in flight hold
    about as many bytes as a scalar join's; at ``feat_elems`` 1 the
    expression is the scalar one."""
    if not (sg.pipeline and sg.pipeline_chunks > 1):
        return cap
    chunks = sg.pipeline_chunks * max(1, int(feat_elems))
    return min(cap, max(8, _pad8(-(-cap // chunks))))


def _double_buffer(sg: ShardedGraph, n: int, issue: Callable,
                   finish: Callable) -> None:
    """``finish(issue(i))`` for i = 0 .. n-1, in order.  Under the
    pipeline ``issue(i)`` (which puts round i on the wire) runs before
    ``finish`` of round i-1 (which waits for its lanes and combines
    them), so one exchange is in flight while the previous one
    combines."""
    if not sg.pipeline:
        for i in range(n):
            finish(issue(i))
        return
    prev = None
    for i in range(n):
        cur = issue(i)
        if prev is not None:
            finish(prev)
        prev = cur
    if prev is not None:
        finish(prev)


def _scatter_received(op: str, buf, base: int, t_recv, v_recv, ident):
    """Combine received (target, value) lanes into my local buffer;
    lanes that are not mine (padding) are masked.  ``v_recv`` may carry
    a trailing feature axis."""
    slot = t_recv.long() - base
    okr = (slot >= 0) & (slot < buf.shape[0])
    scatter_op(op, buf, torch.where(okr, slot, 0).reshape(-1),
               torch.where(feat_mask(okr, v_recv, okr.dim()), v_recv, ident
                           ).reshape((-1,) + tuple(buf.shape[1:])))


def _routed_scatter_combine(sg: ShardedGraph, targets, values, valid,
                            op: str, cap=None) -> torch.Tensor:
    """Destination-routed combine: (L,) lanes of (global target, value)
    are bucketed by owner device, exchanged in cap-sized ``all_to_all``
    rounds and combined into MY local (m_loc*n_loc[, F]) buffer.
    Received lanes that are not mine (padding) are masked before the
    scatter.  ``values`` is (L,) or feature-blocked (L, F): the (cap, F)
    blocks ride the same rounds, at a cap shrunk by F under the pipeline.
    Under the pipeline the rounds are double-buffered; they still combine
    in order, so the result is bitwise the same."""
    if sg.hier:
        return _hier_scatter_combine(sg, targets, values, valid, op, cap)
    loc_n = sg.m_loc * sg.n_loc
    L = targets.shape[0]
    feat = feat_shape(values, 1)
    cap = _pipeline_cap(sg, cap or _cap_for(L, sg.D), _feat_elems(feat))
    ident = identity_of(op, values.dtype)
    order, off = _bucket(sg, targets, valid)
    st_ = _with_sentinel(torch.where(valid, targets, sg.n_pad)[order],
                         sg.n_pad)
    sv_ = _with_sentinel(torch.where(feat_mask(valid, values, 1), values,
                                     ident)[order], ident)
    rounds = _rounds_for(sg, off, cap)
    base = sg.w0 * sg.n_loc
    buf = torch.full((loc_n,) + feat, ident, dtype=values.dtype,
                     device=sg.device)

    def issue(r):
        idxc, ok = _round_lanes(off, r, cap, L)
        sv_c = sv_[idxc]
        return (sg.start(torch.where(ok, st_[idxc], sg.n_pad)),
                sg.start(torch.where(feat_mask(ok, sv_c, 2), sv_c, ident)))

    def finish(sent):
        _scatter_received(op, buf, base, sent[0].wait(), sent[1].wait(),
                          ident)
    _double_buffer(sg, rounds, issue, finish)
    return buf


def _hier_caps(sg: ShardedGraph, L: int, cap,
               feat_elems: int = 1) -> Tuple[int, int]:
    """Per-level lane caps of one hierarchical routed exchange.  A flat
    int cap is a 1-D quantity and would under-cap the funnel legs (the
    intra-host leg routes to T columns, the inter-host leg a column's
    residue to H hosts), so unless an explicit ``(cap1, cap2)`` pair is
    given both are derived per level from the level-aware hints.  The
    pipeline chunks the inter-host leg (by ``feat_elems`` more for a
    feature-blocked payload)."""
    if isinstance(cap, tuple):
        cap1, cap2 = int(cap[0]), int(cap[1])
    else:
        cap1 = _cap_for(L, sg.T, sg.cap_hint_w)
        cap2 = _cap_for(sg.T * cap1, sg.H, sg.cap_hint_h)
    return cap1, _pipeline_cap(sg, cap2, feat_elems)


def _hier_scatter_combine(sg: ShardedGraph, targets, values, valid,
                          op: str, cap=None) -> torch.Tensor:
    """2-D twin of ``_routed_scatter_combine``: lanes first go to the
    destination *column* within my host (host-group rounds), the column
    device segment-combines what it received by target (the per-level
    Theorem-1 combine), and only the combined residue crosses to the
    owner host (column-group rounds, double-buffered under the pipeline).
    The inner round count is read once an outer round, all-reduced over
    the whole group."""
    n_pad = sg.n_pad
    L = targets.shape[0]
    feat = feat_shape(values, 1)
    cap1, cap2 = _hier_caps(sg, L, cap, _feat_elems(feat))
    ident = identity_of(op, values.dtype)
    order, off = _bucket(sg, targets, valid, "w")
    st_ = _with_sentinel(torch.where(valid, targets, n_pad)[order], n_pad)
    sv_ = _with_sentinel(torch.where(feat_mask(valid, values, 1), values,
                                     ident)[order], ident)
    rounds1 = _rounds_for(sg, off, cap1)
    base = sg.w0 * sg.n_loc
    L2 = sg.T * cap1
    zerow = torch.zeros(L2, dtype=torch.int32, device=sg.device)
    buf = torch.full((sg.m_loc * sg.n_loc,) + feat, ident,
                     dtype=values.dtype, device=sg.device)
    for r in range(rounds1):
        idxc, ok = _round_lanes(off, r, cap1, L)
        sv_c = sv_[idxc]
        tf = sg.all_to_all(torch.where(ok, st_[idxc], n_pad),
                           sg.group_w).reshape(-1)
        vf = sg.all_to_all(torch.where(feat_mask(ok, sv_c, 2), sv_c, ident),
                           sg.group_w).reshape((-1,) + feat)
        # the intermediate combine: duplicates aimed at one target merge
        # BEFORE crossing hosts (worker key 0: keyed by target alone)
        realf, seg_t, seg_val, _, _ = planlib.sorted_segments_flat(
            tf, vf, tf < n_pad, zerow, op, n_pad)
        ord2, off2 = _bucket(sg, seg_t, realf, "h")
        t2_ = _with_sentinel(torch.where(realf, seg_t, n_pad)[ord2], n_pad)
        v2_ = _with_sentinel(torch.where(feat_mask(realf, seg_val, 1),
                                         seg_val, ident)[ord2], ident)
        rounds2 = _rounds_for(sg, off2, cap2, inner=True)

        def issue(r2, off2=off2, t2_=t2_, v2_=v2_):
            i2, ok2 = _round_lanes(off2, r2, cap2, L2)
            v2_c = v2_[i2]
            return (sg.start(torch.where(ok2, t2_[i2], n_pad), sg.group_h),
                    sg.start(torch.where(feat_mask(ok2, v2_c, 2), v2_c,
                                         ident), sg.group_h))

        def finish(sent):
            _scatter_received(op, buf, base, sent[0].wait(), sent[1].wait(),
                              ident)
        _double_buffer(sg, rounds2, issue, finish)
    return buf


def _answer(sg: ShardedGraph, flat, req_r: torch.Tensor) -> torch.Tensor:
    """The owner's side of a request round: my value (or (F,) row) at
    each received request, 0 where the request is not mine (padding)."""
    loc_n = flat.shape[0]
    slot = req_r.long() - sg.w0 * sg.n_loc
    okr = (slot >= 0) & (slot < loc_n)
    got = flat[slot.clamp(0, loc_n - 1)]
    return torch.where(feat_mask(okr, got, okr.dim()), got, 0)


def _fetch_rounds(sg: ShardedGraph, flat, req_sorted, off, cap: int,
                  L: int, rounds: int, group) -> torch.Tensor:
    """The round trips of a routed fetch over ``group``: requests out in
    cap-sized rounds, owners answer, responses back on the same lanes.
    Under the pipeline round r's trip is issued before round r-1's
    responses are written (they write disjoint lanes).  Returns the (L,)
    (or (L, F)) responses in bucket order."""
    out = torch.zeros((L + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=sg.device)

    def issue(r):
        idxc, ok = _round_lanes(off, r, cap, L)
        req_r = sg.start(torch.where(ok, req_sorted[idxc], sg.n_pad),
                         group).wait()
        return idxc, ok, sg.start(_answer(sg, flat, req_r), group)

    def finish(trip):
        idxc, ok, resp = trip
        resp = resp.wait()
        # lanes outside the window write the sentinel slot L
        out[torch.where(ok, idxc, L)] = torch.where(
            feat_mask(ok, resp, 2), resp, 0)
    _double_buffer(sg, rounds, issue, finish)
    return out[:L]


def _routed_fetch(sg: ShardedGraph, vals, targets, valid,
                  cap=None) -> torch.Tensor:
    """The request-respond transport, a two-way trip: (L,) global
    ``targets`` are bucketed by owner device, requests go out in cap-sized
    ``all_to_all`` rounds, owners answer from their local (m_loc, n_loc[,
    F]) rows, responses come back on the same lanes.  Returns (L[, F])
    values, 0 where ``~valid`` (the reference's convention for masked
    requests)."""
    if sg.hier:
        return _hier_routed_fetch(sg, vals, targets, valid, cap)
    L = targets.shape[0]
    feat = feat_shape(vals, 2)
    cap = _pipeline_cap(sg, cap or _cap_for(L, sg.D), _feat_elems(feat))
    ok_t = valid & (targets >= 0) & (targets < sg.n_pad)
    order, off = _bucket(sg, targets, ok_t)
    st_ = _with_sentinel(torch.where(ok_t, targets, sg.n_pad)[order],
                         sg.n_pad)
    rounds = _rounds_for(sg, off, cap)
    got_sorted = _fetch_rounds(sg, vals.reshape((-1,) + feat), st_, off,
                               cap, L, rounds, None)
    got = torch.zeros((L,) + feat, dtype=vals.dtype, device=sg.device)
    got[order] = got_sorted
    return torch.where(feat_mask(ok_t, got, 1), got, 0)


def _carry_heads(first: torch.Tensor, head_vals: torch.Tensor
                 ) -> torch.Tensor:
    """Carry each segment head's value (or (F,) row) down its segment
    (``first`` marks the heads of sorted lanes): by segment id, a cumsum,
    where the reference takes a running max of head positions, which
    torch's cummax makes a slow scan on the card."""
    L = first.shape[0]
    seg = (torch.cumsum(first, 0) - 1).clamp(min=0)
    per_seg = torch.zeros((L + 1,) + tuple(head_vals.shape[1:]),
                          dtype=head_vals.dtype, device=head_vals.device)
    idx = torch.where(first, seg, L)
    per_seg.scatter_(0, idx.view((-1,) + (1,) * (head_vals.dim() - 1)
                                 ).expand_as(head_vals), head_vals)
    return per_seg[seg]


def _hier_routed_fetch(sg: ShardedGraph, vals, targets, valid,
                       cap=None) -> torch.Tensor:
    """2-D twin of ``_routed_fetch``: requests first go to the owner's
    *column* within my host (host-group rounds); the column device sorts
    the host's requests and deduplicates them, so one head request per
    distinct target crosses hosts (Theorem 3 per level); the owner
    answers over the column-group trip, the response is carried down the
    duplicates and returned over the host-group lanes."""
    n_pad = sg.n_pad
    L = targets.shape[0]
    feat = feat_shape(vals, 2)
    cap1, cap2 = _hier_caps(sg, L, cap, _feat_elems(feat))
    flat = vals.reshape((-1,) + feat)
    ok_t = valid & (targets >= 0) & (targets < n_pad)
    order, off = _bucket(sg, targets, ok_t, "w")
    st_ = _with_sentinel(torch.where(ok_t, targets, n_pad)[order], n_pad)
    rounds1 = _rounds_for(sg, off, cap1)
    Lr = sg.T * cap1
    out = torch.zeros((L + 1,) + feat, dtype=vals.dtype, device=sg.device)
    for r in range(rounds1):
        idxc, ok = _round_lanes(off, r, cap1, L)
        reqs = sg.all_to_all(torch.where(ok, st_[idxc], n_pad),
                             sg.group_w).reshape(-1)
        # the gateway: one head request per distinct target of the host
        ord2 = torch.argsort(reqs, stable=True)
        rs = reqs[ord2]
        first = (rs < n_pad) & torch.cat([
            torch.ones(1, dtype=torch.bool, device=sg.device),
            rs[1:] != rs[:-1]])
        ord3, off2 = _bucket(sg, rs, first, "h")
        rh_ = _with_sentinel(torch.where(first, rs, n_pad)[ord3], n_pad)
        rounds2 = _rounds_for(sg, off2, cap2, inner=True)
        head3 = _fetch_rounds(sg, flat, rh_, off2, cap2, Lr, rounds2,
                              sg.group_h)
        heads = torch.zeros((Lr,) + feat, dtype=vals.dtype,
                            device=sg.device)
        heads[ord3] = head3
        got = torch.zeros((Lr,) + feat, dtype=vals.dtype, device=sg.device)
        got[ord2] = _carry_heads(first, heads)
        got = torch.where(feat_mask(reqs < n_pad, got, 1), got, 0
                          ).view((sg.T, cap1) + feat)
        resp = sg.all_to_all(got, sg.group_w)
        out[torch.where(ok, idxc, L)] = torch.where(feat_mask(ok, resp, 2),
                                                    resp, 0)
    got = torch.zeros((L,) + feat, dtype=vals.dtype, device=sg.device)
    got[order] = out[:L]
    return torch.where(feat_mask(ok_t, got, 1), got, 0)


def _fetch_planned(sg: ShardedGraph, fp: ShardFetch, flat_vals, fill
                   ) -> torch.Tensor:
    """Run one static fetch plan: returns my compact (n_need[, F])
    values.  ``flat_vals`` is my local (m_loc*n_loc[, F]) owner-side
    array; the -1 padding of the tables is clamped and masked, and each
    (F,) row rides its slot's lane.  On the 2-D mesh the values ride the
    gateway's two legs: one inter-host lane per (slot, consuming host),
    then the fan-out within the host."""
    feat = tuple(flat_vals.shape[1:])

    def pick(src, slots):
        g = src[slots.clamp(0, src.shape[0] - 1)]
        return torch.where(feat_mask(slots >= 0, g, slots.dim()), g, fill)

    def scatter_into(size, pos, recv):
        buf = torch.full((size + 1,) + feat, fill, dtype=flat_vals.dtype,
                         device=sg.device)
        buf[torch.where(pos >= 0, pos, size).reshape(-1)] = recv.reshape(
            (-1,) + feat)
        return buf[:-1]

    if fp.a_send is not None:
        recv_a = sg.all_to_all(pick(flat_vals, fp.a_send), sg.group_h)
        gw = scatter_into(fp.n_gw, fp.a_recv, recv_a)
        recv = sg.all_to_all(pick(gw, fp.b_send), sg.group_w)
        return scatter_into(fp.n_need, fp.b_recv, recv)
    recv = sg.all_to_all(pick(flat_vals, fp.send_slot))
    return scatter_into(fp.n_need, fp.recv_pos, recv)

# ---------------------------------------------------------------------------
# sharded channel implementations
# ---------------------------------------------------------------------------

def _plan_seg_hits(plan: ShardPlan, flat_hits: torch.Tensor
                   ) -> torch.Tensor:
    """(n_segs, nb) bool: did >= 1 real message land in each (source,
    block) slot?  The same block combine as the values, a max over 0/1
    lanes (``plan.plan_seg_hits`` on a rank's plan)."""
    hitp = (plan.row_valid & flat_hits[plan.row_gather]).to(torch.int32)
    rh = planlib._combine_rows(hitp, plan.row_local, "max", plan.nb)
    sh = torch.zeros((plan.n_segs, plan.nb), dtype=torch.int32,
                     device=hitp.device)
    return scatter_op("max", sh, plan.row_seg, rh) > 0


def _scatter_blocks(op: str, loc, blk, val, recv, ident):
    """Scatter received (K, cap, nb[, F]) segment partials into my local
    block range at ``blk``, masked by ``val``."""
    m = val.view(tuple(val.shape) + (1,) * (recv.dim() - val.dim()))
    scatter_op(op, loc, torch.where(val, blk, 0).reshape(-1),
               torch.where(m, recv, ident).reshape((-1,)
                                                   + tuple(loc.shape[1:])))


def _plan_exchange_pipelined(sg: ShardedGraph, plan: ShardPlan, flat_vals,
                             op: str, loc, ident) -> None:
    """The chunked plan exchange of the 1-D mesh: chunk c's row subset
    runs through the scalar kernel (``plan.combine_rows_subset``, one
    launch a chunk) and its segment partials go on the wire before chunk
    c-1's received partials scatter into ``loc``."""
    def issue(c):
        rows_ok = plan.crow_ok[c]
        row_out = planlib.combine_rows_subset(plan, flat_vals, plan.crow[c],
                                              rows_ok, op, dp=plan)
        seg_out = scatter_op(
            op, torch.full((plan.cs, plan.nb), ident, dtype=flat_vals.dtype,
                           device=sg.device),
            torch.where(rows_ok, plan.crow_seg[c], 0),
            torch.where(rows_ok[:, None], row_out, ident))
        g = seg_out[plan.cxseg[c]]
        return c, sg.start(torch.where(plan.cxval[c][:, :, None], g, ident))

    def finish(sent):
        c, recv = sent
        _scatter_blocks(op, loc, plan.crblk[c], plan.crval[c], recv.wait(),
                        ident)
    _double_buffer(sg, plan.n_chunks, issue, finish)


def _plan_exchange_hier(sg: ShardedGraph, plan: ShardPlan, seg_out, op: str,
                        loc, ident) -> None:
    """The two-leg plan exchange of the 2-D mesh: my segment partials
    ride one host-group ``all_to_all`` to the device of their destination
    column, which combines what it received by global destination block
    (``n_iseg`` intermediate segments), and only the combined residue
    crosses hosts.  Under the pipeline the inter-host leg is cut into
    ``plan.hchunks`` static position chunks, double-buffered."""
    g1 = seg_out[plan.x1seg]
    recv1 = sg.all_to_all(torch.where(plan.x1val[:, :, None], g1, ident),
                          sg.group_w)
    ibuf = torch.full((plan.n_iseg, plan.nb), ident, dtype=seg_out.dtype,
                      device=sg.device)
    _scatter_blocks(op, ibuf, plan.iscat, plan.ival, recv1, ident)
    _leg2(sg, plan.hchunks, plan.x2cap, ibuf, plan.x2seg, plan.x2val,
          plan.r2blk, plan.r2val, op, loc, ident)


def _leg2(sg: ShardedGraph, hchunks: int, x2cap: int, ibuf, x2seg, x2val,
          r2blk, r2val, op: str, loc, ident) -> None:
    """The inter-host leg of a 2-D plan exchange: intermediate segments
    ``ibuf[x2seg]`` to the owner hosts over the column group, scattered
    there into ``loc`` at ``r2blk``; under the pipeline in ``hchunks``
    static position chunks, double-buffered (every rank alike: the tables
    are stacked, so empty last chunks are skipped everywhere)."""
    C = hchunks if sg.pipeline else 1
    ck = -(-x2cap // C)
    sls = [slice(c * ck, min((c + 1) * ck, x2cap)) for c in range(C)]
    sls = [s for s in sls if s.start < s.stop]

    def issue(c):
        sl = sls[c]
        g2 = ibuf[x2seg[:, sl]]
        m = x2val[:, sl].view(tuple(x2val[:, sl].shape)
                              + (1,) * (g2.dim() - 2))
        return sl, sg.start(torch.where(m, g2, ident), sg.group_h)

    def finish(sent):
        sl, recv = sent
        _scatter_blocks(op, loc, r2blk[:, sl], r2val[:, sl], recv.wait(),
                        ident)
    _double_buffer(sg, len(sls), issue, finish)


def _vec_rows(plan: ShardPlan, values: EdgeMap, op: str, work, ident,
              rows: Optional[torch.Tensor] = None) -> None:
    """Combine plan rows (all of them, or the int64 ``rows``) through the
    vector ``segment_combine`` kernel in chunks of
    ``plan.vec_chunk_rows`` rows (one launch each), each chunk's lanes
    computed from ``values`` and its (rows, nb, F) output merged at once
    into ``work`` at its rows' blocks."""
    itemsize = torch.empty((), dtype=values.dtype).element_size()
    step = planlib.vec_chunk_rows(plan, values.feat, itemsize)
    n = plan.n_rows if rows is None else rows.shape[0]
    for r0 in range(0, n, step):
        sel = slice(r0, r0 + step) if rows is None else rows[r0:r0 + step]
        packed = torch.where(plan.row_valid[sel][..., None],
                             values.take(plan.row_gather[sel]), ident)
        out = planlib._combine_rows(packed, plan.row_local[sel], op,
                                    plan.nb)
        del packed
        scatter_op(op, work, plan.vec_plan().row_dst[sel], out)


def _combine_plan_vec_sharded(sg: ShardedGraph, plan: ShardPlan,
                              values: EdgeMap, op: str, exchange: bool
                              ) -> torch.Tensor:
    """The feature-blocked per-rank plan combine (``VecPlan``): my rows in
    vector chunks, merged straight into my blocks or into the send slots
    of the segments that leave me, which then take the 1-D exchange (one
    ``all_to_all``; under the pipeline chunk by chunk, a pipeline chunk's
    rows split again into vector chunks) or the two legs of the 2-D mesh.
    Neither the packed lanes, nor the kernel output, nor an (n_segs, nb,
    F) segment buffer exists whole.  Returns the (m_loc, n_loc, F)
    inbox."""
    ident = identity_of(op, values.dtype)
    vp = plan.vec_plan()
    nbl = sg.m_loc * plan.B_per_w
    blk = (plan.nb, values.feat)
    work = torch.full((vp.n_work,) + blk, ident, dtype=values.dtype,
                      device=sg.device)
    loc = work[:nbl]
    if exchange and vp.crows is not None and vp.ccr:
        D, ccr = sg.D, vp.ccr

        def issue(c):
            _vec_rows(plan, values, op, work, ident, vp.crows[c])
            lo = nbl + c * D * ccr
            return c, sg.start(work[lo:lo + D * ccr].view((D, ccr) + blk))

        def finish(sent):
            c, recv = sent
            _scatter_blocks(op, loc, vp.crblk[c], vp.crval[c] & vp.peers,
                            recv.wait(), ident)
        _double_buffer(sg, len(vp.crows), issue, finish)
    else:
        _vec_rows(plan, values, op, work, ident)
        if exchange and sg.hier:
            _vec_exchange_hier(sg, plan, work, op, loc, ident)
        elif exchange and vp.xcr:
            send = work[nbl:nbl + sg.D * vp.xcr].view((sg.D, vp.xcr) + blk)
            _scatter_blocks(op, loc, vp.rblk, vp.rval & vp.peers,
                            sg.all_to_all(send), ident)
    return loc.view(sg.m_loc, plan.B_per_w * plan.nb,
                    values.feat)[:, :sg.n_loc]


def _vec_exchange_hier(sg: ShardedGraph, plan: ShardPlan, work, op: str,
                       loc, ident) -> None:
    """The two legs of the 2-D mesh for the send slots of ``work``: leg 1
    to the destination column's device, which combines what it received
    into its compacted intermediate blocks (those of its own blocks go
    straight into ``loc``), leg 2 (``_leg2``) across hosts."""
    vp = plan.vec_plan()
    if not vp.x1cr:
        return
    nbl = sg.m_loc * plan.B_per_w
    blk = tuple(work.shape[1:])
    send = work[nbl:nbl + sg.T * vp.x1cr].view((sg.T, vp.x1cr) + blk)
    ibuf = torch.full((vp.n_ibuf,) + blk, ident, dtype=work.dtype,
                      device=sg.device)
    _scatter_blocks(op, ibuf, vp.iscat, vp.ival,
                    sg.all_to_all(send, sg.group_w), ident)
    scatter_op(op, loc, vp.self_blk, ibuf[vp.self_iseg])
    if vp.x2cr:
        _leg2(sg, plan.hchunks, vp.x2cr, ibuf, vp.x2seg, vp.x2val,
              vp.r2blk, vp.r2val, op, loc, ident)


def _combine_with_plan_sharded(sg: ShardedGraph, plan: ShardPlan,
                               flat_vals, op: str,
                               flat_hits: Optional[torch.Tensor] = None,
                               count_cross: bool = True,
                               exchange: bool = True):
    """Per-rank destination-blocked combine plus the routed segment
    exchange.  Scalar (E,) values: my rows go through the scalar
    ``segment_combine`` kernel (``plan._combine_rows``, under ``"auto"``
    on a CUDA tensor), my (source, block) segment partials take ONE
    ``all_to_all`` to the ranks owning their blocks (two legs on the 2-D
    mesh; chunked and double-buffered under the 1-D pipeline, one kernel
    launch a chunk), and I scatter what was routed to me into my local
    (m_loc*B_per_w, nb) block range.  Feature-blocked (E, F) values or an
    ``EdgeMap``: ``_combine_plan_vec_sharded``, through the vector
    kernel.  ``exchange=False`` skips the collective when every segment is
    destination-local (the mirror fan-out of a partition that is not
    split: mirror edges are sharded by destination).  Padded exchange
    lanes read segment 0 and are masked to the identity."""
    if isinstance(flat_vals, EdgeMap) or flat_vals.dim() == 2:
        if isinstance(flat_vals, torch.Tensor):
            flat_vals = EdgeMap.of(flat_vals)
        inbox = _combine_plan_vec_sharded(sg, plan, flat_vals, op, exchange)
    else:
        inbox = _combine_plan_scalar(sg, plan, flat_vals, op, exchange)
    if not count_cross:
        return inbox, None
    sh = _plan_seg_hits(plan, flat_hits)
    seg_log = sg.log_of(plan.seg_worker)
    owner = torch.div(plan.seg_blk, plan.B_per_w, rounding_mode="floor")
    per_seg = (sh & (owner != seg_log)[:, None]).sum(dim=1)
    return inbox, (per_seg.sum(), per_worker(seg_log, per_seg, sg.M))


def _combine_plan_scalar(sg: ShardedGraph, plan: ShardPlan, flat_vals, op,
                         exchange: bool) -> torch.Tensor:
    """The scalar body of ``_combine_with_plan_sharded``: returns the
    (m_loc, n_loc) inbox."""
    ident = identity_of(op, flat_vals.dtype)
    nbl = sg.m_loc * plan.B_per_w
    loc = torch.full((nbl, plan.nb), ident, dtype=flat_vals.dtype,
                     device=sg.device)
    if (exchange and sg.pipeline and plan.crow is not None
            and plan.n_chunks > 1):
        _plan_exchange_pipelined(sg, plan, flat_vals, op, loc, ident)
    else:
        packed = torch.where(plan.row_valid, flat_vals[plan.row_gather],
                             ident)
        row_out = planlib._combine_rows(packed, plan.row_local, op, plan.nb)
        seg_out = scatter_op(op, torch.full((plan.n_segs, plan.nb), ident,
                                            dtype=flat_vals.dtype,
                                            device=sg.device),
                             plan.row_seg, row_out)
        if not exchange:
            # every segment is mine: scatter by local block (the padded
            # dummy segments carry identity rows, clamped into range)
            lblk = (plan.seg_blk - sg.w0 * plan.B_per_w).clamp(0, nbl - 1)
            scatter_op(op, loc, lblk, seg_out)
        elif plan.x1seg is not None:
            _plan_exchange_hier(sg, plan, seg_out, op, loc, ident)
        else:
            send = torch.where(plan.xval[:, :, None], seg_out[plan.xseg],
                               ident)
            _scatter_blocks(op, loc, plan.rblk, plan.rval,
                            sg.all_to_all(send), ident)
    return loc.view(sg.m_loc, plan.B_per_w * plan.nb)[:, :sg.n_loc]


def _combine_sorted_rows_sharded(sg: ShardedGraph, targets, values, mask,
                                 op: str):
    """Sharded ``plan.combine_sorted``: the sorted segmented combine on my
    (m_loc, K[, F]) rows, then the surviving segments routed to their
    owners.  Crossness is mask-driven: a live segment IS >= 1 real
    message."""
    real, seg_t, seg_val, seg_row, _ = planlib.sorted_segments(
        targets, values, mask, op, sg.n_pad)
    buf = _routed_scatter_combine(sg, seg_t, seg_val, real, op)
    src_w = seg_row.long() + sg.w0
    cross = real & (torch.div(seg_t, sg.n_loc, rounding_mode="floor")
                    != src_w)
    return (buf.view((sg.m_loc, sg.n_loc) + feat_shape(values, 2)),
            (cross.sum(), per_worker(src_w, cross, sg.M)))


def _combine_sorted_flat_sharded(sg: ShardedGraph, targets, values, mask,
                                 worker, op: str, cap=None):
    """Flat-csr twin: ``plan.sorted_segments_flat`` on my (E_dev[, F])
    edges (source workers global; physical shards under a split
    partition), routed exchange, mask-driven counts by logical worker."""
    real, seg_t, seg_val, seg_w, _ = planlib.sorted_segments_flat(
        targets, values, mask, worker, op, sg.n_pad)
    buf = _routed_scatter_combine(sg, seg_t, seg_val, real, op, cap=cap)
    seg_log = sg.log_of(torch.where(real, seg_w, 0))
    cross = real & (torch.div(seg_t, sg.n_loc, rounding_mode="floor")
                    != seg_log)
    return (buf.view((sg.m_loc, sg.n_loc) + feat_shape(values, 1)),
            (cross.sum(), per_worker(seg_log, cross, sg.M)))


def _combined_stats(msgs, pw, base) -> Dict[str, torch.Tensor]:
    stats = {"msgs_combined": msgs, "per_worker_combined": pw}
    stats.update(base)
    return stats


def push_combined_sharded(sg: ShardedGraph, targets, values, mask, op: str,
                          backend: str = "dense",
                          plan: Optional[ShardPlan] = None,
                          count: bool = True):
    """Sharded Ch_msg, padded rows: my (m_loc, K) edges; ``values`` is
    (m_loc, K), (m_loc, K, F) or an ``EdgeMap`` of the m_loc*K edges.
    With a plan the combine runs destination-blocked through the kernel;
    without one through the sorted segmented core.  Stats are this rank's
    part (none when ``count`` is False)."""
    ident = identity_of(op, values.dtype)
    base = {}
    if count:
        raw_cross = mask & (torch.div(targets, sg.n_loc,
                                      rounding_mode="floor")
                            != sg.worker_ids()[:, None])
        base = {"msgs_basic": raw_cross.sum(),
                "per_worker_basic": _place_rows(sg, raw_cross.sum(dim=1))}
    if backend == "pallas" and plan is not None:
        if isinstance(values, EdgeMap):
            masked = values.where(mask.reshape(-1), ident)
        else:
            masked = torch.where(feat_mask(mask, values, 2), values, ident)
            masked = masked.reshape((-1,) + feat_shape(values, 2))
        inbox, cnt = _combine_with_plan_sharded(
            sg, plan, masked, op, flat_hits=mask.reshape(-1),
            count_cross=count)
    else:
        if isinstance(values, EdgeMap):
            values = values.materialize().view(targets.shape
                                               + (values.feat,))
        inbox, cnt = _combine_sorted_rows_sharded(sg, targets, values, mask,
                                                  op)
    return inbox, (_combined_stats(*cnt, base) if count else {})


def push_combined_flat_sharded(sg: ShardedGraph, targets, values, mask,
                               worker, op: str, backend: str = "dense",
                               plan: Optional[ShardPlan] = None,
                               count: bool = True):
    """Sharded Ch_msg, csr layout: my flat (E_dev,) edges with global
    per-edge source workers (physical shards under a split partition: a
    shard never straddles devices, so the per-rank distinct-pair counts
    sum exactly); ``values`` is (E_dev,), (E_dev, F) or an ``EdgeMap``."""
    worker = worker.long()
    ident = identity_of(op, values.dtype)
    base = {}
    if count:
        wlog = sg.log_of(worker)
        raw_cross = mask & (torch.div(targets, sg.n_loc,
                                      rounding_mode="floor") != wlog)
        base = {"msgs_basic": raw_cross.sum(),
                "per_worker_basic": per_worker(wlog, raw_cross, sg.M)}
    if backend == "pallas" and plan is not None:
        if isinstance(values, EdgeMap):
            masked = values.where(mask, ident)
        else:
            masked = torch.where(feat_mask(mask, values, 1), values, ident)
        inbox, cnt = _combine_with_plan_sharded(
            sg, plan, masked, op, flat_hits=mask, count_cross=count)
    else:
        if isinstance(values, EdgeMap):
            values = values.materialize()
        cap = (_cap_for(targets.shape[0], sg.D, sg.cap_hint)
               if sg.cap_hint else None)
        inbox, cnt = _combine_sorted_flat_sharded(
            sg, targets, values, mask, worker, op, cap=cap)
    return inbox, (_combined_stats(*cnt, base) if count else {})


def push_mirror_sharded(sg: ShardedGraph, vals, active, op: str,
                        relay: str = "none", backend: str = "dense",
                        count: bool = True):
    """Sharded Ch_mir: each rank fetches the mirror values its fan-out
    edges reference through the static mirror fetch plan (owners serve
    their active mirrored vertices; one ``all_to_all``), then fans out on
    its local mirror edges; under a split partition the fan-out's
    destinations may be another rank's, so it goes through the exchange.
    A feature-blocked payload fetches the mirrors' activity through the
    same plan (a feature may equal the identity) and fans out as an
    ``EdgeMap``.  Stats are owner-side: a mirrored vertex is owned by
    exactly one rank, so the partial counts sum exactly."""
    ident = identity_of(op, vals.dtype)
    n_pad = sg.n_pad
    loc_n = sg.m_loc * sg.n_loc
    feat = feat_shape(vals, 2)
    flat_vals = vals.reshape((-1,) + feat)
    flat_act = active.reshape(-1)
    contrib = torch.where(feat_mask(flat_act, flat_vals, 1), flat_vals,
                          ident)                      # owner-side payload
    lv = _fetch_planned(sg, sg.fetch["mir"], contrib, ident)
    if feat:
        la = _fetch_planned(sg, sg.fetch["mir"], flat_act.to(torch.int32), 0)
        act_e = sg.mir_emask & (la[sg.mir_cesrc] > 0)
        ev = _edge_map(lv, sg.mir_cesrc.reshape(-1), sg.mir_ew.reshape(-1),
                       relay).where(act_e.reshape(-1), ident)
        if backend != "pallas":
            ev = ev.materialize().view(act_e.shape + feat)
    else:
        raw = lv[sg.mir_cesrc]
        act_e = sg.mir_emask & (raw != ident)
        ev = torch.where(act_e, relay_values(raw, sg.mir_ew, relay), ident)
    if backend == "pallas":
        inbox, _ = _combine_with_plan_sharded(
            sg, sg.plans["mir"], ev if feat else ev.reshape(-1), op,
            count_cross=False, exchange=sg.split)
    elif sg.split:
        inbox = _routed_scatter_combine(sg, sg.mir_edst, ev, act_e, op
                                        ).view((sg.m_loc, sg.n_loc) + feat)
    else:
        if sg.layout == "csr":
            idx = sg.mir_edst.long() - sg.w0 * sg.n_loc
        else:
            row = torch.arange(sg.m_loc, device=sg.device)[:, None]
            idx = row * sg.n_loc + torch.where(sg.mir_emask, sg.mir_edst,
                                               0).long()
        buf = torch.full((loc_n,) + feat, ident, dtype=vals.dtype,
                         device=sg.device)
        inbox = scatter_op(op, buf, idx.reshape(-1),
                           ev.reshape((-1,) + feat)
                           ).view((sg.m_loc, sg.n_loc) + feat)
    if not count:
        return inbox, {}
    # owner-side mask-driven stats: an ACTIVE mirrored vertex is broadcast
    # to its hosting workers whatever its value; each rank charges the
    # mirrored vertices it owns
    safe_g = sg.mir_ids.long().clamp(0, n_pad - 1)
    slot = safe_g - sg.w0 * sg.n_loc
    owned = (sg.mir_ids < n_pad) & (slot >= 0) & (slot < loc_n)
    act = flat_act[slot.clamp(0, loc_n - 1)]
    sent = torch.where(owned & act, sg.mir_nworkers.long(), 0)
    owner_w = torch.div(safe_g, sg.n_loc, rounding_mode="floor")
    return inbox, {"msgs_mirror": sent.sum(),
                   "per_worker_mirror": per_worker(owner_w, sent, sg.M)}


def broadcast_sharded(sg: ShardedGraph, vals, active, op: str,
                      relay: str = "none", use_mirroring: bool = True,
                      backend: str = "dense", count: bool = True):
    """Sharded ``channels.broadcast`` (the same stats keys; none when
    ``count`` is False, as a training join asks).  ``vals`` is this
    rank's (m_loc, n_loc) or feature-blocked (m_loc, n_loc, F) rows; a
    feature-blocked join hands the combine an ``EdgeMap`` that composes
    the source read (local rows, or under a split partition the fetched
    compact values), the relay and the masks, never an (E_dev, F)
    array."""
    kind = "eg" if use_mirroring else "all"
    esrc = getattr(sg, f"{kind}_src").long()
    edst = getattr(sg, f"{kind}_dst")
    emask = getattr(sg, f"{kind}_mask")
    ew = getattr(sg, f"{kind}_w")
    feat = feat_shape(vals, 2)
    plan = sg.plans.get(kind) if backend == "pallas" else None
    if backend == "pallas" and plan is None:
        raise ValueError(f"the sharded graph was built without the {kind!r} "
                         "plan: pass plan_kinds=broadcast_plan_kinds(...)")
    flat = vals.reshape((-1,) + feat)
    if sg.layout == "csr":
        if sg.split:
            # edge-balanced device bounds: sources may be another rank's,
            # read through the edge set's static source fetch plan
            fp, index = sg.fetch[kind], getattr(sg, f"{kind}_csrc")
            rows = _fetch_planned(sg, fp, flat, 0)
            src_act = _fetch_planned(sg, fp, active.reshape(-1).to(
                torch.int32), 0)[index] > 0
            worker = getattr(sg, f"{kind}_pw")
        else:
            index = esrc - sg.w0 * sg.n_loc
            rows = flat
            src_act = active.reshape(-1)[index]
            worker = torch.div(esrc, sg.n_loc, rounding_mode="floor")
        v = (_edge_map(rows, index, ew, relay) if feat
             else relay_values(rows[index], ew, relay))
        inbox, stats = push_combined_flat_sharded(
            sg, edst, v, emask & src_act, worker, op, backend=backend,
            plan=plan, count=count)
    else:
        if feat:
            row = torch.arange(sg.m_loc, device=sg.device)[:, None]
            v = _edge_map(flat, (row * sg.n_loc + esrc).reshape(-1),
                          ew.reshape(-1), relay)
        else:
            v = relay_values(torch.gather(vals, 1, esrc), ew, relay)
        inbox, stats = push_combined_sharded(
            sg, edst, v, emask & torch.gather(active, 1, esrc), op,
            backend=backend, plan=plan, count=count)
    if use_mirroring:
        inbox2, s2 = push_mirror_sharded(sg, vals, active, op, relay,
                                         backend=backend, count=count)
        inbox = _MERGE[op](inbox, inbox2)
        stats.update(s2)
    elif count:
        stats["msgs_mirror"] = torch.zeros((), dtype=torch.int64,
                                           device=sg.device)
        stats["per_worker_mirror"] = torch.zeros(sg.M, dtype=torch.int64,
                                                 device=sg.device)
    if count:
        stats["msgs_total"] = stats["msgs_combined"] + stats["msgs_mirror"]
        stats["per_worker_total"] = (stats["per_worker_combined"]
                                     + stats["per_worker_mirror"])
    return inbox, stats


def gather_sharded(sg: ShardedGraph, vals, targets, tmask,
                   dedup: bool = True):
    """Sharded Ch_req for row-shaped targets (m_loc, R): each worker's
    deduplicated requests travel to their owners and back
    (``_routed_fetch``), an (F,) row a request when ``vals`` is
    feature-blocked; the Theorem-3 counts are this rank's part."""
    n_pad = sg.n_pad
    feat = feat_shape(vals, 2)
    t = torch.where(tmask, targets, n_pad)
    R = t.shape[1]
    if dedup:
        uniq, inv = _dedup_row(t, n_pad)
    else:
        uniq = t
        inv = torch.arange(R, device=sg.device).expand(t.shape)
    flat_u = uniq.reshape(-1)
    got = _routed_fetch(sg, vals, flat_u, flat_u < n_pad
                        ).view(uniq.shape + feat)
    # a row whose requests are all masked has inv == -1 (JAX wraps it):
    # clamp, the row is masked out below
    inv = inv.long().clamp(min=0)
    out = torch.gather(got, 1, inv.view(inv.shape + (1,) * len(feat)
                                        ).expand(inv.shape + feat))
    out = torch.where(feat_mask(tmask, out, 2), out, 0)

    owner = torch.div(uniq, sg.n_loc, rounding_mode="floor").clamp(
        0, sg.M - 1)
    self_w = sg.worker_ids()[:, None]
    remote_u = (uniq < n_pad) & (owner != self_w)
    tw = torch.div(targets, sg.n_loc, rounding_mode="floor")
    raw_remote = tmask & (tw != self_w)
    stats = {
        "msgs_rr": 2 * remote_u.sum(),
        "msgs_basic": 2 * raw_remote.sum(),
        "per_worker_rr": (_place_rows(sg, remote_u.sum(dim=1))
                          + per_worker(owner.reshape(-1),
                                       remote_u.reshape(-1), sg.M)),
        "per_worker_basic": (_place_rows(sg, raw_remote.sum(dim=1))
                             + per_worker(tw.clamp(0, sg.M - 1).reshape(-1),
                                          raw_remote.reshape(-1), sg.M)),
    }
    return out, stats


def _edge_workers(sg: ShardedGraph) -> torch.Tensor:
    """The source worker of each local csr edge of the ``all`` set: its
    physical shard under a split partition."""
    if sg.split:
        return sg.all_pw
    return torch.div(sg.all_src.long(), sg.n_loc, rounding_mode="floor")


def gather_edges_sharded(sg: ShardedGraph, vals, targets, tmask,
                         dedup: bool = True):
    """Sharded Ch_req for edge-shaped targets.  The transport always rides
    the deduplicated (worker, target) segment heads (physical shards under
    a split partition); responses, scalars or (F,) rows, are carried back
    down each segment."""
    if sg.layout != "csr":
        return gather_sharded(sg, vals, targets, tmask, dedup)
    n_pad = sg.n_pad
    feat = feat_shape(vals, 2)
    worker = _edge_workers(sg)
    wlog = sg.log_of(worker)
    t = torch.where(tmask, targets, n_pad)
    order, ws, ts, first = planlib.sort_by_worker_target(worker, t)
    heads = first & (ts < n_pad)
    cap = (_cap_for(t.shape[0], sg.D, sg.cap_hint) if sg.cap_hint
           else None)
    head_vals = _routed_fetch(sg, vals, ts, heads, cap=cap)
    out = torch.zeros((t.shape[0],) + feat, dtype=vals.dtype,
                      device=sg.device)
    out[order] = _carry_heads(first, head_vals)
    out = torch.where(feat_mask(t < n_pad, out, 1), out, 0)

    tw = torch.div(targets, sg.n_loc, rounding_mode="floor")
    owner = tw.clamp(0, sg.M - 1)
    raw_remote = tmask & (tw != wlog)
    if dedup:
        ts_w = torch.div(ts, sg.n_loc, rounding_mode="floor")
        ws_log = sg.log_of(ws)
        remote_u = heads & (ts_w != ws_log)
        u_w, u_owner = ws_log, ts_w.clamp(0, sg.M - 1)
    else:
        remote_u, u_w, u_owner = raw_remote, wlog, owner
    stats = {
        "msgs_rr": 2 * remote_u.sum(),
        "msgs_basic": 2 * raw_remote.sum(),
        "per_worker_rr": (per_worker(u_w, remote_u, sg.M)
                          + per_worker(u_owner, remote_u, sg.M)),
        "per_worker_basic": (per_worker(wlog, raw_remote, sg.M)
                             + per_worker(owner, raw_remote, sg.M)),
    }
    return out, stats


def scatter_state_sharded(sg: ShardedGraph, base, targets, upd, mask,
                          op: str, backend: str = "dense"):
    """Sharded scatter-``op`` for row-shaped runtime targets (S-V
    hooking): both backends share the sorted segmented combine and the
    routed exchange, as in the reference; ``upd`` may be
    feature-blocked."""
    raw_cross = mask & (torch.div(targets, sg.n_loc, rounding_mode="floor")
                        != sg.worker_ids()[:, None])
    bstats = {"msgs_basic": raw_cross.sum(),
              "per_worker_basic": _place_rows(sg, raw_cross.sum(dim=1))}
    inbox, (msgs, pw) = _combine_sorted_rows_sharded(sg, targets, upd, mask,
                                                     op)
    return _MERGE[op](base, inbox), _combined_stats(msgs, pw, bstats)


def scatter_edges_sharded(sg: ShardedGraph, base, targets, upd, mask,
                          op: str, backend: str = "dense"):
    """Sharded scatter-``op`` for edge-shaped runtime values (MSF
    election)."""
    if sg.layout != "csr":
        return scatter_state_sharded(sg, base, targets, upd, mask, op,
                                     backend)
    worker = _edge_workers(sg)
    wlog = sg.log_of(worker)
    raw_cross = mask & (torch.div(targets, sg.n_loc, rounding_mode="floor")
                        != wlog)
    bstats = {"msgs_basic": raw_cross.sum(),
              "per_worker_basic": per_worker(wlog, raw_cross, sg.M)}
    inbox, (msgs, pw) = _combine_sorted_flat_sharded(sg, targets, upd, mask,
                                                     worker, op)
    return _MERGE[op](base, inbox), _combined_stats(msgs, pw, bstats)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _gather_state(sg: ShardedGraph, tree):
    """The global state from every rank's rows: one ``all_gather`` for
    each row-sharded leaf (dim >= 1); scalars are replicated already."""
    if isinstance(tree, torch.Tensor):
        return sg.all_gather_rows(tree) if tree.dim() >= 1 else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_gather_state(sg, x) for x in tree)
    raise TypeError(f"unsupported state leaf {type(tree)}")


def _info(sg: ShardedGraph, supersteps: int) -> dict:
    return {"host_reads": sg.host_reads + supersteps,
            "rounds": list(sg.rounds),
            "inner_rounds": list(sg.inner_rounds), "build_s": sg.build_s,
            "table_bytes": sg.table_bytes()}


def run_sharded(pg, make_step: Callable, init: Callable,
                max_supersteps: int, record_history: bool = False,
                devices=1, plan_kinds: Sequence[str] = (),
                device=None, final: Optional[Callable] = None,
                pipeline: bool = False,
                pipeline_chunks: Optional[int] = None):
    """Run a BSP program over the ranks of the default process group
    (``devices`` an int or an ``(H, T)`` mesh; ``pipeline`` double-buffers
    the exchanges in about ``pipeline_chunks`` chunks a join).

    ``make_step(g)`` and ``init(g)`` build the superstep function and the
    initial state against a PartitionedGraph or this rank's
    ShardedGraph.  Returns ``(final_state, stats_totals, n_supersteps,
    history, info)``: the first four as ``bsp.run`` returns them, global
    and the same on every rank (``final(state)``, default the whole
    state, is gathered once at the end), and ``info`` with the rank's
    host reads (one a superstep for the halt vote, one a routed join or
    inter-host leg for its round count; an algorithm's own reads, as
    MSF's jump votes, are not among them), the rounds of each routed join
    (``inner_rounds``: those of the inter-host legs), the host seconds of
    the table builds so far and the device bytes of the tables."""
    sg = shard(pg, devices, plan_kinds, device, pipeline, pipeline_chunks)
    return run_on(sg, make_step(sg), init(sg), max_supersteps,
                  record_history, final)


def run_on(sg: ShardedGraph, step: Callable, state, max_supersteps: int,
           record_history: bool = False, final: Optional[Callable] = None):
    """Run a built superstep function ``step`` (``make_step(sg)``) from
    this rank's initial ``state`` on a resident ShardedGraph; returns what
    ``run_sharded`` returns.  Every rank of the default group calls it
    with the same program."""
    sg.reset_counts()
    st, stats, n, hist = bsp.run(step, state, max_supersteps,
                                 record_history=record_history,
                                 vote=sg.gall, reduce=sg.all_reduce)
    out = _gather_state(sg, st if final is None else final(st))
    return out, stats, n, hist, _info(sg, n)


def _tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def place_args(sg: ShardedGraph, tree, is_sharded: Optional[Callable] = None):
    """This rank's view of a tree of global inputs: the leaves that
    ``is_sharded`` (leaf -> bool; default, a leading axis of ``sg.M``)
    accepts keep this rank's rows, the others are replicated; every tensor
    moves to the rank's device.  A tree whose replicated leaves may have M
    rows (an (M, hidden) weight) passes its own rule."""
    if is_sharded is None:
        def is_sharded(x):
            return x.dim() >= 1 and x.shape[0] == sg.M

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        if is_sharded(x):
            x = x[sg.w0:sg.w0 + sg.m_loc]
        return x.to(sg.device)
    return _tree_map(leaf, tree)


def apply_sharded(pg, make_fn: Callable, args: tuple, devices=1,
                  plan_kinds: Sequence[str] = (), device=None,
                  pipeline: bool = False,
                  pipeline_chunks: Optional[int] = None):
    """One sharded channel application (no BSP loop): ``make_fn(g)``
    returns ``fn(*args) -> (out, stats)``.  Leaves of ``args`` with a
    leading axis of ``pg.M`` are split by rows (this rank's, moved to its
    device, ``place_args``).  ``out`` comes back gathered along its
    leading axis in rank order (csr edge-shaped outputs then carry each
    rank's padding: strip it with ``device_edge_bounds``), ``stats``
    summed over the ranks, and ``info`` as ``run_sharded`` gives it."""
    sg = shard(pg, devices, plan_kinds, device, pipeline, pipeline_chunks)
    out, stats = make_fn(sg)(*place_args(sg, tuple(args)))
    for v in stats.values():
        sg.all_reduce(v)
    return sg.all_gather_rows(out), stats, _info(sg, 0)
