"""Sharded superstep executor over ``torch.distributed``: the worker axis
as D real devices (the counterpart of ``repro.core.exec`` on its 1-D
mesh).

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
once per (partition, D, rank, device) and cached on the partition; the
message plans of a kind are added the first time a run needs them.

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

Collectives (``ShardedGraph``): ``all_to_all_single`` on (D, cap, ...)
buffers with equal splits; ``gany``/``gall`` as an int32 ``all_reduce``
(gloo has no bool reduction); ``gsum`` and ``gmax`` as ``all_reduce``.  The
message counts are not reduced inside a superstep: every rank keeps its
own int64 partial counts, and ``run_sharded`` / ``apply_sharded`` reduce
the totals (and the history) with one ``all_reduce`` each at the end of
the run.  The counts are sums over ranks, so the totals equal the
reference's psum'd ones integer for integer.

Loops: the reference's ``lax.fori_loop`` over exchange rounds is a Python
loop over the host-read round count; ``bsp.run`` votes ``halted`` over all
ranks before its one host read a superstep.  Every rank therefore issues
the same collectives in the same order.

Parity contract (``tests/test_torch_sharded.py``): ``devices=D`` gives the
single-device result bitwise for integer, min and max combines, sums
(PageRank) to float round-off, and every ``msgs_*`` / ``per_worker_*``
integer-exact, in the same number of supersteps.

Not in this module yet: the (hosts, per_host) mesh, the pipelined
exchanges, ``balance="split"`` device bounds, frozen shard profiles, and
feature-blocked payloads (the sharded GNN path); ``api.check_config`` and
the channels refuse them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bsp
from repro_torch.core import plan as planlib
from repro_torch.core.channels import _dedup_row, relay_values
from repro_torch.core.plan import identity_of, per_worker, scatter_op

_MERGE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def broadcast_plan_kinds(backend: str, use_mirroring: bool = True) -> tuple:
    """The message plans the executor builds per device for one
    ``channels.broadcast`` configuration."""
    if backend != "pallas":
        return ()
    return ("eg", "mir") if use_mirroring else ("all",)


def _normalize_devices(devices):
    """``devices`` is an int (the 1-D worker mesh) or a ``(hosts,
    per_host)`` pair (the 2-D mesh, refused by this port).  Returns
    ``(D, hier)``."""
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


# ---------------------------------------------------------------------------
# host tables: per-device plans, fetch plans, device slices
# ---------------------------------------------------------------------------

def _device_plans(pg, D: int, kind: str, nb: int):
    """One EdgePlan per device over that device's workers' edges, with
    *global* source workers in ``seg_worker`` (the accounting) and
    *global* destination blocks (the exchange's address space)."""
    M, n_loc = pg.M, pg.n_loc
    m = M // D
    h = pg.host

    def build(d, eb):
        if pg.layout == "csr":
            if kind in ("eg", "all"):
                src, dst = h[f"{kind}_src"], h[f"{kind}_dst"]
                off = pg.eg_off if kind == "eg" else pg.all_off
                s, e = int(off[d * m]), int(off[(d + 1) * m])
                sw = src[s:e] // n_loc
            else:
                dst = h["mir_edst"]
                s, e = int(pg.mir_eoff[d * m]), int(pg.mir_eoff[(d + 1) * m])
                sw = dst[s:e] // n_loc
            return planlib.build_edge_plan_flat(
                sw, dst[s:e] // n_loc, dst[s:e] % n_loc, M, M, n_loc, nb,
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


def _stack_plans(plans, m: int):
    """Pad the per-device plans to common row / segment counts, build the
    per-destination-device exchange index lists, and stack everything with
    a leading device axis.  Returns ``(meta, arrays)``.

    Dummy rows have ``row_valid`` all False (they combine to the identity
    into segment 0) and dummy segments are left out of the exchange lists.
    ``xseg``/``xval`` list MY segments per destination device (send
    side); ``rblk``/``rval`` give, per source device, the local block of
    each segment routed to me (receive side).  Both are static, so the
    ``all_to_all`` caps are exact."""
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
    return meta, a


def _build_fetch_plan(need_lists, D: int, loc_n: int):
    """``need_lists``: per-device sorted unique GLOBAL slot ids; the owner
    of slot g is ``g // loc_n``.  Returns ``(meta, arrays)``: per device
    the LOCAL slots it sends to each consumer (``send_slot``, -1 pad) and
    the compact position of each value it receives (``recv_pos``, -1
    pad)."""
    n_need = max(1, max((len(x) for x in need_lists), default=1))
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


def csr_device_bounds(off: np.ndarray, M: int, D: int) -> np.ndarray:
    """(D+1,) edge offsets at device boundaries of a (M+1,) worker csr."""
    m = M // D
    return np.asarray(off)[np.arange(0, M + 1, m)]


def device_edge_bounds(pg, devices) -> Dict[str, np.ndarray]:
    """Per-device (D+1,) edge bounds of each csr edge set, at worker
    multiples (m = M/D workers a device).  Split partitions place them
    between physical shards, which this port does not run sharded yet."""
    D, _ = _normalize_devices(devices)
    if pg.phys_log is not None:
        raise NotImplementedError(
            'balance="split" device bounds come with a later slice of the '
            "port")
    return {"phys": None,
            "eg": csr_device_bounds(pg.eg_off, pg.M, D),
            "all": csr_device_bounds(pg.all_off, pg.M, D),
            "mir": csr_device_bounds(pg.mir_eoff, pg.M, D)}


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
    edge-shaped exchanges."""
    pc = pg.pair_counts
    if pc is None or pg.phys_log is not None:
        return None
    m = pg.M // D
    return int(pc.reshape(D, m, D, m).sum(axis=(1, 3)).max())


def _shard_graph(pg, D: int, plan_kinds: Sequence[str], nb: int):
    """The device-stacked host tables of ``pg`` over D devices: csr edge
    sets sliced at device bounds and padded to the per-device maximum
    (padding sources point at a real local slot, masked), padded-layout
    rows as they are (sliced by rows later), the mirror fetch plan, and
    the stacked message plans of ``plan_kinds``.  Returns
    ``(meta, arrays)``, arrays with a leading D (csr edges, plans, fetch
    tables) or M (vertex rows, padded edges) axis, or replicated."""
    M, n_loc = pg.M, pg.n_loc
    m = M // D
    loc_n = m * n_loc
    h = pg.host
    arrays: Dict[str, np.ndarray] = {
        "vmask": h["vmask"], "deg": h["deg"], "mir_ids": h["mir_ids"],
        "mir_nworkers": h["mir_nworkers"]}
    meta = {"M": M, "n_loc": n_loc, "D": D, "m_loc": m, "n": pg.n,
            "tau": pg.tau, "layout": pg.layout, "cap_hint": _cap_hint(pg, D),
            "plan_meta": {}, "fetch_meta": {}}
    if pg.layout == "csr":
        base = np.arange(D) * m * n_loc        # a safe in-range pad id
        zero = np.zeros(D)
        for name, off in (("eg", pg.eg_off), ("all", pg.all_off)):
            bounds = csr_device_bounds(off, M, D)
            src, vs = _pad_device_slices(h[f"{name}_src"], bounds, base)
            arrays[f"{name}_src"] = src
            arrays[f"{name}_dst"] = _pad_device_slices(
                h[f"{name}_dst"], bounds, zero)[0]
            arrays[f"{name}_w"] = _pad_device_slices(
                h[f"{name}_w"], bounds, zero)[0]
            arrays[f"{name}_mask"] = vs
        bounds = csr_device_bounds(pg.mir_eoff, M, D)
        esrc, vs = _pad_device_slices(h["mir_esrc"], bounds, zero)
        arrays.update(
            mir_esrc=esrc, mir_emask=vs,
            mir_edst=_pad_device_slices(h["mir_edst"], bounds, base)[0],
            mir_ew=_pad_device_slices(h["mir_ew"], bounds, zero)[0])
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
    fmeta, farr = _build_fetch_plan(need_lists, D, loc_n)
    meta["fetch_meta"]["mir"] = fmeta
    for k, v in farr.items():
        arrays[f"fetch_mir_{k}"] = v
    arrays["mir_cesrc"] = np.stack(cesrc)
    for kind in plan_kinds:
        meta["plan_meta"][kind], parrs = _stacked_plan(pg, D, kind, nb)
        arrays.update(parrs)
    return meta, arrays


def _stacked_plan(pg, D: int, kind: str, nb: int):
    """(meta, ``plan_<kind>_*`` arrays) of one kind's stacked plans."""
    pmeta, parrs = _stack_plans(_device_plans(pg, D, kind, nb), pg.M // D)
    return pmeta, {f"plan_{kind}_{k}": v for k, v in parrs.items()}


# ---------------------------------------------------------------------------
# the device-local graph view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardPlan:
    """One rank's slice of a stacked message plan, on its device (the
    reference's ``TracedPlan`` on the 1-D mesh).  Row and segment counts
    are the maxima over devices."""
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
    seg_worker: torch.Tensor   # (n_segs,) int64 global source worker
    xseg: torch.Tensor         # (D, xcap) int64 my segment per dest device
    xval: torch.Tensor         # (D, xcap) bool
    rblk: torch.Tensor         # (D, xcap) int64 local block per source
    rval: torch.Tensor         # (D, xcap) bool


@dataclasses.dataclass
class ShardFetch:
    """One rank's slice of a static fetch plan (the reference's
    ``TracedFetch`` on the 1-D mesh)."""
    n_need: int
    cap: int
    send_slot: torch.Tensor    # (D, cap) int64 LOCAL slot, -1 pad
    recv_pos: torch.Tensor     # (D, cap) int64 compact position, -1 pad


@dataclasses.dataclass
class ShardedGraph:
    """One rank's view of a PartitionedGraph: ``M``/``n_loc`` stay
    *global* (owner arithmetic, per-worker stats), the vertex rows and
    edge arrays are this rank's, and the ``g*`` reductions are
    collectives.  The channels see ``sharded`` and route to the
    implementations below.

    ``rounds`` and ``host_reads`` record, for the run at hand, the
    exchange rounds of each routed join and the host reads they made."""
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
    build_s: float = 0.0                 # host seconds of the table build
    rounds: List[int] = dataclasses.field(default_factory=list)
    host_reads: int = 0
    sharded = True

    @property
    def n_pad(self) -> int:
        return self.M * self.n_loc

    @property
    def w0(self) -> int:
        """Global index of this rank's first worker."""
        return self.rank * self.m_loc

    def table_bytes(self) -> int:
        """Device bytes of this rank's tables (edges, fetch and plans)."""
        tensors = [v for v in vars(self).values()
                   if isinstance(v, torch.Tensor)]
        for p in list(self.plans.values()) + list(self.fetch.values()):
            tensors += [v for v in vars(p).values()
                        if isinstance(v, torch.Tensor)]
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

    # -- collectives --------------------------------------------------------
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block d of axis 0 goes to rank d; block s of the result came
        from rank s (``jax.lax.all_to_all(x, axis, 0, 0)``)."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous())
        return out

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """In-place all-reduce of ``x`` (a number tensor)."""
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

    def edge_src_values(self, state: torch.Tensor, src: torch.Tensor
                        ) -> torch.Tensor:
        """``state`` at each local edge's source: ``src`` holds global
        slot ids in csr (always this rank's), local slots in padded
        rows."""
        if self.layout == "csr":
            return state.reshape(-1)[src.long() - self.w0 * self.n_loc]
        return torch.gather(state, 1, src.long())


def _slice(meta, arrays, name: str, rank: int) -> np.ndarray:
    """This rank's part of one host table of ``_shard_graph``."""
    m = meta["m_loc"]
    a = arrays[name]
    if name in ("mir_ids", "mir_nworkers"):
        return a                                     # replicated
    if name in ("vmask", "deg") or (meta["layout"] != "csr"
                                    and name != "mir_cesrc"):
        return a[rank * m:(rank + 1) * m]            # worker rows
    return a[rank]                                   # device-stacked


def _upload(a: np.ndarray, device, long: bool = False) -> torch.Tensor:
    """``a`` on ``device``; index arrays (``long``) as int64."""
    a = np.ascontiguousarray(a, dtype=np.int64 if long else None)
    return torch.as_tensor(a, device=device)


def _make_plan(meta, arrays, kind: str, rank: int, device) -> ShardPlan:
    pm = meta["plan_meta"][kind]

    def part(k, long=False):
        return _upload(arrays[f"plan_{kind}_{k}"][rank], device, long)
    return ShardPlan(
        nb=pm["nb"], eb=pm["eb"], B_per_w=pm["B_per_w"],
        n_rows=pm["n_rows"], n_segs=pm["n_segs"], xcap=pm["xcap"],
        row_gather=part("row_gather", long=True),
        row_valid=part("row_valid"), row_local=part("row_local"),
        row_seg=part("row_seg", long=True),
        seg_blk=part("seg_blk", long=True),
        seg_worker=part("seg_worker", long=True),
        xseg=part("xseg", long=True), xval=part("xval"),
        rblk=part("rblk", long=True), rval=part("rval"))


def _make_sg(meta, arrays, rank: int, device) -> ShardedGraph:
    """Move this rank's slice of the host tables to ``device``."""
    def loc(name, long=False):
        return _upload(_slice(meta, arrays, name, rank), device, long)

    fetch = {}
    for name, fm in meta["fetch_meta"].items():
        fetch[name] = ShardFetch(
            n_need=fm["n_need"], cap=fm["cap"],
            send_slot=_upload(arrays[f"fetch_{name}_send_slot"][rank],
                              device, long=True),
            recv_pos=_upload(arrays[f"fetch_{name}_recv_pos"][rank],
                             device, long=True))
    mir_esrc = loc("mir_esrc")
    cesrc = loc("mir_cesrc", long=True).reshape(mir_esrc.shape)
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
        fetch=fetch,
        plans={k: _make_plan(meta, arrays, k, rank, device)
               for k in meta["plan_meta"]},
        cap_hint=meta["cap_hint"])


# ---------------------------------------------------------------------------
# the process group, and the per-partition cache of shard views
# ---------------------------------------------------------------------------

def world(M: Optional[int], devices, device) -> tuple:
    """``(D, rank)`` of the default process group, after checking that it
    matches ``devices`` and divides ``M`` workers (no fallback: a missing
    or mismatched group raises)."""
    D, hier = _normalize_devices(devices)
    if hier is not None:
        raise NotImplementedError(
            f"devices={devices!r}: the (hosts, per_host) sharded mesh "
            "comes with a later slice of the port; pass an int")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"devices={D} runs one process per device over "
            "torch.distributed: call torch.distributed.init_process_group"
            f"(backend, init_method, world_size={D}, rank=r) in each of "
            f"{D} processes first (NCCL between GPUs, one GPU a rank; gloo "
            "between CPU processes), or launch them with "
            f"`python -m repro_torch.launch.graph_run --devices {D}`")
    size = dist.get_world_size()
    if size != D:
        raise RuntimeError(f"devices={D}, but the default process group "
                           f"has world size {size}")
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


def shard(pg, devices, plan_kinds: Sequence[str] = (), device=None
          ) -> ShardedGraph:
    """This rank's ShardedGraph of ``pg`` on ``device`` (default: the
    partition's device), with the message plans of ``plan_kinds``.  Built
    once per (D, rank, device) and cached on ``pg``; the plans of a kind
    are added when first asked for.  Only ``pg``'s host tables are read."""
    device = torch.device(pg.device if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    D, rank = world(pg.M, devices, device)
    if pg.phys_log is not None:
        raise NotImplementedError(
            'balance="split" with devices: the physical-shard device '
            "placement comes with a later slice of the port")
    nb = planlib.default_nb(device)
    key = ("shard", D, rank, str(device), nb)
    sg = pg.plan_cache.get(key)
    t0 = time.perf_counter()
    if sg is None:
        meta, arrays = _shard_graph(pg, D, plan_kinds, nb)
        sg = pg.plan_cache[key] = _make_sg(meta, arrays, rank, device)
        sg.build_s = time.perf_counter() - t0
    for kind in [k for k in plan_kinds if k not in sg.plans]:
        t0 = time.perf_counter()
        pmeta, arrays = _stacked_plan(pg, D, kind, nb)
        sg.plans[kind] = _make_plan({"plan_meta": {kind: pmeta}}, arrays,
                                    kind, rank, device)
        sg.build_s += time.perf_counter() - t0
    sg.rounds = []
    sg.host_reads = 0
    return sg


# ---------------------------------------------------------------------------
# routed exchange cores
# ---------------------------------------------------------------------------

def _place_rows(sg: ShardedGraph, local_counts: torch.Tensor
                ) -> torch.Tensor:
    """(m_loc,) per-local-worker counts -> this rank's (M,) partial."""
    full = torch.zeros(sg.M, dtype=torch.int64, device=sg.device)
    full[sg.w0:sg.w0 + sg.m_loc] = local_counts
    return full


def _bucket_by_device(sg: ShardedGraph, targets, valid):
    """Sort lanes by destination device (invalid last).  Returns
    (order, (D+1,) bucket offsets).  The target is clamped before the
    owner division, as the reference clips it."""
    loc_n = sg.m_loc * sg.n_loc
    dd = torch.where(valid, torch.div(targets.clamp(0, sg.n_pad - 1), loc_n,
                                      rounding_mode="floor"), sg.D
                     ).to(torch.int32)                # 32-bit sort keys
    order = torch.argsort(dd, stable=True)
    off = torch.searchsorted(dd[order], torch.arange(
        sg.D + 1, dtype=torch.int32, device=sg.device))
    return order, off


def _rounds_for(sg: ShardedGraph, off: torch.Tensor, cap: int) -> int:
    """The all-reduced number of ``all_to_all`` rounds of one routed join,
    read on the host once: balanced traffic fits the cap in one round, a
    hot destination adds rounds."""
    counts = off[1:] - off[:-1]
    r = ((counts + cap - 1) // cap).max().reshape(1)
    rounds = sg.read_int(sg.all_reduce(r, dist.ReduceOp.MAX)[0])
    sg.rounds.append(rounds)
    return rounds


def _round_lanes(off: torch.Tensor, r: int, cap: int, L: int):
    """Round ``r``'s (D, cap) lane window into the device-sorted arrays:
    per destination device the slice [off[d] + r*cap, off[d+1]) clipped to
    ``cap`` lanes.  Returns (indices, in-bucket validity).  The indices
    are clamped into [0, L]: the sorted arrays carry one sentinel lane at
    L, so a rank with no lanes (L = 0) still reads in bounds, where the
    reference's ``clip(idx, 0, L - 1)`` would give -1."""
    idx = (off[:-1, None] + r * cap
           + torch.arange(cap, device=off.device)[None])
    ok = idx < off[1:, None]
    return idx.clamp(0, L), ok


def _with_sentinel(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([x, torch.full((1,), fill, dtype=x.dtype,
                                    device=x.device)])


def _check_scalar(x: torch.Tensor, lane_ndim: int) -> None:
    if x.dim() != lane_ndim:
        raise NotImplementedError(
            "feature-blocked payloads on the sharded executor come with "
            "the sharded GNN path, a later slice of the port")


def _routed_scatter_combine(sg: ShardedGraph, targets, values, valid,
                            op: str, cap: Optional[int] = None
                            ) -> torch.Tensor:
    """Destination-routed combine: (L,) lanes of (global target, value)
    are bucketed by owner device, exchanged in cap-sized ``all_to_all``
    rounds and combined into MY local (m_loc*n_loc,) buffer.  Received
    lanes that are not mine (padding) are masked before the scatter."""
    loc_n = sg.m_loc * sg.n_loc
    L = targets.shape[0]
    cap = cap or _cap_for(L, sg.D)
    ident = identity_of(op, values.dtype)
    order, off = _bucket_by_device(sg, targets, valid)
    st_ = _with_sentinel(torch.where(valid, targets, sg.n_pad)[order],
                         sg.n_pad)
    sv_ = _with_sentinel(torch.where(valid, values, ident)[order], ident)
    rounds = _rounds_for(sg, off, cap)
    base = sg.w0 * sg.n_loc
    buf = torch.full((loc_n,), ident, dtype=values.dtype, device=sg.device)
    for r in range(rounds):
        idxc, ok = _round_lanes(off, r, cap, L)
        t_recv = sg.all_to_all(torch.where(ok, st_[idxc], sg.n_pad))
        v_recv = sg.all_to_all(torch.where(ok, sv_[idxc], ident))
        slot = t_recv.long() - base
        okr = (slot >= 0) & (slot < loc_n)
        scatter_op(op, buf, torch.where(okr, slot, 0).reshape(-1),
                   torch.where(okr, v_recv, ident).reshape(-1))
    return buf


def _routed_fetch(sg: ShardedGraph, vals, targets, valid,
                  cap: Optional[int] = None) -> torch.Tensor:
    """The request-respond transport, a two-way trip: (L,) global
    ``targets`` are bucketed by owner device, requests go out in cap-sized
    ``all_to_all`` rounds, owners answer from their local (m_loc, n_loc)
    rows, responses come back on the same lanes.  Returns (L,) values, 0
    where ``~valid`` (the reference's convention for masked requests)."""
    loc_n = sg.m_loc * sg.n_loc
    L = targets.shape[0]
    cap = cap or _cap_for(L, sg.D)
    flat = vals.reshape(-1)
    ok_t = valid & (targets >= 0) & (targets < sg.n_pad)
    order, off = _bucket_by_device(sg, targets, ok_t)
    st_ = _with_sentinel(torch.where(ok_t, targets, sg.n_pad)[order],
                         sg.n_pad)
    rounds = _rounds_for(sg, off, cap)
    base = sg.w0 * sg.n_loc
    out = torch.zeros(L + 1, dtype=vals.dtype, device=sg.device)
    for r in range(rounds):
        idxc, ok = _round_lanes(off, r, cap, L)
        req_r = sg.all_to_all(torch.where(ok, st_[idxc], sg.n_pad))
        slot = req_r.long() - base
        okr = (slot >= 0) & (slot < loc_n)
        resp = torch.where(okr, flat[slot.clamp(0, loc_n - 1)], 0)
        resp_b = sg.all_to_all(resp)
        # lanes outside the window write the sentinel slot L
        out[torch.where(ok, idxc, L)] = torch.where(ok, resp_b, 0)
    got = torch.zeros(L, dtype=vals.dtype, device=sg.device)
    got[order] = out[:L]
    return torch.where(ok_t, got, 0)


def _fetch_planned(sg: ShardedGraph, fp: ShardFetch, flat_vals, fill
                   ) -> torch.Tensor:
    """Run one static fetch plan: returns my compact (n_need,) values.
    ``flat_vals`` is my local (m_loc*n_loc,) owner-side array; the -1
    padding of ``send_slot``/``recv_pos`` is clamped and masked."""
    n = flat_vals.shape[0]
    gs = flat_vals[fp.send_slot.clamp(0, n - 1)]
    recv = sg.all_to_all(torch.where(fp.send_slot >= 0, gs, fill))
    idx = torch.where(fp.recv_pos >= 0, fp.recv_pos, fp.n_need)
    buf = torch.full((fp.n_need + 1,), fill, dtype=flat_vals.dtype,
                     device=sg.device)
    buf[idx.reshape(-1)] = recv.reshape(-1)
    return buf[:-1]


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


def _combine_with_plan_sharded(sg: ShardedGraph, plan: ShardPlan,
                               flat_vals: torch.Tensor, op: str,
                               flat_hits: Optional[torch.Tensor] = None,
                               count_cross: bool = True,
                               exchange: bool = True):
    """Per-rank destination-blocked combine plus the routed segment
    exchange: my rows go through the scalar ``segment_combine`` kernel
    (``plan._combine_rows``, under ``"auto"`` on a CUDA tensor), my
    (source, block) segment partials take ONE ``all_to_all`` to the ranks
    owning their blocks, and I scatter what was routed to me into my
    local (m_loc*B_per_w, nb) block range.  ``exchange=False`` skips the
    collective when every segment is destination-local (the mirror
    fan-out: mirror edges are sharded by destination).  Padded exchange
    lanes read segment 0 and are masked to the identity."""
    ident = identity_of(op, flat_vals.dtype)
    nbl = sg.m_loc * plan.B_per_w
    packed = torch.where(plan.row_valid, flat_vals[plan.row_gather], ident)
    row_out = planlib._combine_rows(packed, plan.row_local, op, plan.nb)
    seg_out = scatter_op(op, torch.full((plan.n_segs, plan.nb), ident,
                                        dtype=flat_vals.dtype,
                                        device=sg.device),
                         plan.row_seg, row_out)
    loc = torch.full((nbl, plan.nb), ident, dtype=flat_vals.dtype,
                     device=sg.device)
    if exchange:
        send = torch.where(plan.xval[:, :, None], seg_out[plan.xseg], ident)
        recv = sg.all_to_all(send)
        scatter_op(op, loc, torch.where(plan.rval, plan.rblk, 0).reshape(-1),
                   torch.where(plan.rval[:, :, None], recv,
                               ident).reshape(-1, plan.nb))
    else:
        # every segment is mine: scatter by local block (the padded dummy
        # segments carry identity rows, clamped into range)
        lblk = (plan.seg_blk - sg.w0 * plan.B_per_w).clamp(0, nbl - 1)
        scatter_op(op, loc, lblk, seg_out)
    inbox = loc.view(sg.m_loc, plan.B_per_w * plan.nb)[:, :sg.n_loc]
    if not count_cross:
        return inbox, None
    sh = _plan_seg_hits(plan, flat_hits)
    owner = torch.div(plan.seg_blk, plan.B_per_w, rounding_mode="floor")
    per_seg = (sh & (owner != plan.seg_worker)[:, None]).sum(dim=1)
    return inbox, (per_seg.sum(), per_worker(plan.seg_worker, per_seg, sg.M))


def _combine_sorted_rows_sharded(sg: ShardedGraph, targets, values, mask,
                                 op: str):
    """Sharded ``plan.combine_sorted``: the sorted segmented combine on my
    (m_loc, K) rows, then the surviving segments routed to their owners.
    Crossness is mask-driven: a live segment IS >= 1 real message."""
    real, seg_t, seg_val, seg_row, _ = planlib.sorted_segments(
        targets, values, mask, op, sg.n_pad)
    buf = _routed_scatter_combine(sg, seg_t, seg_val, real, op)
    src_w = seg_row.long() + sg.w0
    cross = real & (torch.div(seg_t, sg.n_loc, rounding_mode="floor")
                    != src_w)
    return (buf.view(sg.m_loc, sg.n_loc),
            (cross.sum(), per_worker(src_w, cross, sg.M)))


def _combine_sorted_flat_sharded(sg: ShardedGraph, targets, values, mask,
                                 worker, op: str,
                                 cap: Optional[int] = None):
    """Flat-csr twin: ``plan.sorted_segments_flat`` on my (E_dev,) edges
    (source workers global), routed exchange, mask-driven counts."""
    real, seg_t, seg_val, seg_w, _ = planlib.sorted_segments_flat(
        targets, values, mask, worker, op, sg.n_pad)
    buf = _routed_scatter_combine(sg, seg_t, seg_val, real, op, cap=cap)
    seg_w = torch.where(real, seg_w, 0).long()
    cross = real & (torch.div(seg_t, sg.n_loc, rounding_mode="floor")
                    != seg_w)
    return (buf.view(sg.m_loc, sg.n_loc),
            (cross.sum(), per_worker(seg_w, cross, sg.M)))


def _combined_stats(msgs, pw, base) -> Dict[str, torch.Tensor]:
    stats = {"msgs_combined": msgs, "per_worker_combined": pw}
    stats.update(base)
    return stats


def push_combined_sharded(sg: ShardedGraph, targets, values, mask, op: str,
                          backend: str = "dense",
                          plan: Optional[ShardPlan] = None):
    """Sharded Ch_msg, padded rows: my (m_loc, K) edges.  With a plan the
    combine runs destination-blocked through the kernel; without one
    through the sorted segmented core.  Stats are this rank's part."""
    raw_cross = mask & (torch.div(targets, sg.n_loc, rounding_mode="floor")
                        != sg.worker_ids()[:, None])
    base = {"msgs_basic": raw_cross.sum(),
            "per_worker_basic": _place_rows(sg, raw_cross.sum(dim=1))}
    if backend == "pallas" and plan is not None:
        masked = torch.where(mask, values, identity_of(op, values.dtype))
        inbox, (msgs, pw) = _combine_with_plan_sharded(
            sg, plan, masked.reshape(-1), op, flat_hits=mask.reshape(-1))
    else:
        inbox, (msgs, pw) = _combine_sorted_rows_sharded(
            sg, targets, values, mask, op)
    return inbox, _combined_stats(msgs, pw, base)


def push_combined_flat_sharded(sg: ShardedGraph, targets, values, mask,
                               worker, op: str, backend: str = "dense",
                               plan: Optional[ShardPlan] = None):
    """Sharded Ch_msg, csr layout: my flat (E_dev,) edges with global
    per-edge source workers."""
    worker = worker.long()
    raw_cross = mask & (torch.div(targets, sg.n_loc, rounding_mode="floor")
                        != worker)
    base = {"msgs_basic": raw_cross.sum(),
            "per_worker_basic": per_worker(worker, raw_cross, sg.M)}
    if backend == "pallas" and plan is not None:
        masked = torch.where(mask, values, identity_of(op, values.dtype))
        inbox, (msgs, pw) = _combine_with_plan_sharded(
            sg, plan, masked, op, flat_hits=mask)
    else:
        cap = (_cap_for(targets.shape[0], sg.D, sg.cap_hint)
               if sg.cap_hint else None)
        inbox, (msgs, pw) = _combine_sorted_flat_sharded(
            sg, targets, values, mask, worker, op, cap=cap)
    return inbox, _combined_stats(msgs, pw, base)


def push_mirror_sharded(sg: ShardedGraph, vals, active, op: str,
                        relay: str = "none", backend: str = "dense"):
    """Sharded Ch_mir: each rank fetches the mirror values its fan-out
    edges reference through the static mirror fetch plan (owners serve
    their active mirrored vertices; one ``all_to_all``), then fans out on
    its local mirror edges.  Stats are owner-side: a mirrored vertex is
    owned by exactly one rank, so the partial counts sum exactly."""
    ident = identity_of(op, vals.dtype)
    n_pad = sg.n_pad
    loc_n = sg.m_loc * sg.n_loc
    flat_vals = vals.reshape(-1)
    flat_act = active.reshape(-1)
    contrib = torch.where(flat_act, flat_vals, ident)   # owner-side payload
    lv = _fetch_planned(sg, sg.fetch["mir"], contrib, ident)
    raw = lv[sg.mir_cesrc]
    act_e = sg.mir_emask & (raw != ident)
    ev = torch.where(act_e, relay_values(raw, sg.mir_ew, relay), ident)
    if backend == "pallas":
        inbox, _ = _combine_with_plan_sharded(
            sg, sg.plans["mir"], ev.reshape(-1), op, count_cross=False,
            exchange=False)
    else:
        if sg.layout == "csr":
            idx = sg.mir_edst.long() - sg.w0 * sg.n_loc
        else:
            row = torch.arange(sg.m_loc, device=sg.device)[:, None]
            idx = row * sg.n_loc + torch.where(sg.mir_emask, sg.mir_edst,
                                               0).long()
        buf = torch.full((loc_n,), ident, dtype=vals.dtype, device=sg.device)
        inbox = scatter_op(op, buf, idx.reshape(-1), ev.reshape(-1)
                           ).view(sg.m_loc, sg.n_loc)
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
                      backend: str = "dense"):
    """Sharded ``channels.broadcast`` (the same stats keys)."""
    _check_scalar(vals, 2)
    kind = "eg" if use_mirroring else "all"
    esrc = getattr(sg, f"{kind}_src").long()
    edst = getattr(sg, f"{kind}_dst")
    emask = getattr(sg, f"{kind}_mask")
    ew = getattr(sg, f"{kind}_w")
    plan = sg.plans.get(kind) if backend == "pallas" else None
    if backend == "pallas" and plan is None:
        raise ValueError(f"the sharded graph was built without the {kind!r} "
                         "plan: pass plan_kinds=broadcast_plan_kinds(...)")
    if sg.layout == "csr":
        loc_src = esrc - sg.w0 * sg.n_loc
        v = relay_values(vals.reshape(-1)[loc_src], ew, relay)
        inbox, stats = push_combined_flat_sharded(
            sg, edst, v, emask & active.reshape(-1)[loc_src],
            torch.div(esrc, sg.n_loc, rounding_mode="floor"), op,
            backend=backend, plan=plan)
    else:
        v = relay_values(torch.gather(vals, 1, esrc), ew, relay)
        inbox, stats = push_combined_sharded(
            sg, edst, v, emask & torch.gather(active, 1, esrc), op,
            backend=backend, plan=plan)
    if use_mirroring:
        inbox2, s2 = push_mirror_sharded(sg, vals, active, op, relay,
                                         backend=backend)
        inbox = _MERGE[op](inbox, inbox2)
        stats.update(s2)
    else:
        stats["msgs_mirror"] = torch.zeros((), dtype=torch.int64,
                                           device=sg.device)
        stats["per_worker_mirror"] = torch.zeros(sg.M, dtype=torch.int64,
                                                 device=sg.device)
    stats["msgs_total"] = stats["msgs_combined"] + stats["msgs_mirror"]
    stats["per_worker_total"] = (stats["per_worker_combined"]
                                 + stats["per_worker_mirror"])
    return inbox, stats


def gather_sharded(sg: ShardedGraph, vals, targets, tmask,
                   dedup: bool = True):
    """Sharded Ch_req for row-shaped targets (m_loc, R): each worker's
    deduplicated requests travel to their owners and back
    (``_routed_fetch``); the Theorem-3 counts are this rank's part."""
    _check_scalar(vals, 2)
    n_pad = sg.n_pad
    t = torch.where(tmask, targets, n_pad)
    R = t.shape[1]
    if dedup:
        uniq, inv = _dedup_row(t, n_pad)
    else:
        uniq = t
        inv = torch.arange(R, device=sg.device).expand(t.shape)
    flat_u = uniq.reshape(-1)
    got = _routed_fetch(sg, vals, flat_u, flat_u < n_pad).view(uniq.shape)
    # a row whose requests are all masked has inv == -1 (JAX wraps it):
    # clamp, the row is masked out below
    out = torch.gather(got, 1, inv.long().clamp(min=0))
    out = torch.where(tmask, out, 0)

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


def gather_edges_sharded(sg: ShardedGraph, vals, targets, tmask,
                         dedup: bool = True):
    """Sharded Ch_req for edge-shaped targets.  The transport always rides
    the deduplicated (worker, target) segment heads; responses are carried
    back down each segment."""
    if sg.layout != "csr":
        return gather_sharded(sg, vals, targets, tmask, dedup)
    _check_scalar(vals, 2)
    n_pad = sg.n_pad
    worker = torch.div(sg.all_src.long(), sg.n_loc, rounding_mode="floor")
    t = torch.where(tmask, targets, n_pad)
    L = t.shape[0]
    order, ws, ts, first = planlib.sort_by_worker_target(worker, t)
    heads = first & (ts < n_pad)
    cap = _cap_for(L, sg.D, sg.cap_hint) if sg.cap_hint else None
    head_vals = _routed_fetch(sg, vals, ts, heads, cap=cap)
    # carry each head's value down its segment: by segment id (a cumsum)
    # where the reference takes a running max of head positions, which
    # torch's cummax makes a slow scan on the card
    seg = torch.cumsum(first, 0) - 1
    per_seg = torch.zeros(L + 1, dtype=vals.dtype, device=sg.device)
    per_seg.scatter_(0, torch.where(first, seg, L), head_vals)
    out = torch.zeros(L, dtype=vals.dtype, device=sg.device)
    out[order] = per_seg[seg]
    out = torch.where(t < n_pad, out, 0)

    tw = torch.div(targets, sg.n_loc, rounding_mode="floor")
    owner = tw.clamp(0, sg.M - 1)
    raw_remote = tmask & (tw != worker)
    if dedup:
        ts_w = torch.div(ts, sg.n_loc, rounding_mode="floor")
        remote_u = heads & (ts_w != ws)
        u_w, u_owner = ws, ts_w.clamp(0, sg.M - 1)
    else:
        remote_u, u_w, u_owner = raw_remote, worker, owner
    stats = {
        "msgs_rr": 2 * remote_u.sum(),
        "msgs_basic": 2 * raw_remote.sum(),
        "per_worker_rr": (per_worker(u_w, remote_u, sg.M)
                          + per_worker(u_owner, remote_u, sg.M)),
        "per_worker_basic": (per_worker(worker, raw_remote, sg.M)
                             + per_worker(owner, raw_remote, sg.M)),
    }
    return out, stats


def scatter_state_sharded(sg: ShardedGraph, base, targets, upd, mask,
                          op: str, backend: str = "dense"):
    """Sharded scatter-``op`` for row-shaped runtime targets (S-V
    hooking): both backends share the sorted segmented combine and the
    routed exchange, as in the reference."""
    _check_scalar(upd, 2)
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
    _check_scalar(upd, 1)
    worker = torch.div(sg.all_src.long(), sg.n_loc, rounding_mode="floor")
    raw_cross = mask & (torch.div(targets, sg.n_loc, rounding_mode="floor")
                        != worker)
    bstats = {"msgs_basic": raw_cross.sum(),
              "per_worker_basic": per_worker(worker, raw_cross, sg.M)}
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
            "rounds": list(sg.rounds), "build_s": sg.build_s,
            "table_bytes": sg.table_bytes()}


def run_sharded(pg, make_step: Callable, init: Callable,
                max_supersteps: int, record_history: bool = False,
                devices: int = 1, plan_kinds: Sequence[str] = (),
                device=None, final: Optional[Callable] = None):
    """Run a BSP program over the D ranks of the default process group.

    ``make_step(g)`` and ``init(g)`` build the superstep function and the
    initial state against a PartitionedGraph or this rank's
    ShardedGraph.  Returns ``(final_state, stats_totals, n_supersteps,
    history, info)``: the first four as ``bsp.run`` returns them, global
    and the same on every rank (``final(state)``, default the whole
    state, is gathered once at the end), and ``info`` with the rank's
    host reads (one a superstep for the halt vote, one a routed join for
    its round count; an algorithm's own reads, as MSF's jump votes, are
    not among them), the rounds of each routed join, the host seconds of
    the table builds so far and the device bytes of the tables."""
    sg = shard(pg, devices, plan_kinds, device)
    st, stats, n, hist = bsp.run(make_step(sg), init(sg), max_supersteps,
                                 record_history=record_history,
                                 vote=sg.gall, reduce=sg.all_reduce)
    out = _gather_state(sg, st if final is None else final(st))
    return out, stats, n, hist, _info(sg, n)


def apply_sharded(pg, make_fn: Callable, args: tuple, devices: int = 1,
                  plan_kinds: Sequence[str] = (), device=None):
    """One sharded channel application (no BSP loop): ``make_fn(g)``
    returns ``fn(*args) -> (out, stats)``.  Leaves of ``args`` with a
    leading axis of ``pg.M`` are split by rows (this rank's, moved to its
    device).  ``out`` comes back gathered along its leading axis in rank
    order (csr edge-shaped outputs then carry each rank's padding: strip
    it with ``device_edge_bounds``), ``stats`` summed over the ranks, and
    ``info`` as ``run_sharded`` gives it."""
    sg = shard(pg, devices, plan_kinds, device)
    m = sg.m_loc
    local = tuple(
        a[sg.w0:sg.w0 + m].to(sg.device)
        if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == sg.M
        else a for a in args)
    out, stats = make_fn(sg)(*local)
    for v in stats.values():
        sg.all_reduce(v)
    return sg.all_gather_rows(out), stats, _info(sg, 0)
