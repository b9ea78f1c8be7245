"""Message plans: destination-blocked layouts for the combine channels
(the counterpart of ``repro.core.plan``).

A *message plan* is built once per partitioned graph, on the host: every
worker's outgoing edges are grouped by (source worker, destination block)
into fixed-width rows.  At superstep time the runtime gathers the per-edge
values into the packed layout and hands the rows to the segment_combine
kernel, so the dense (M, n_pad) per-source partial never materializes.

Blocking scheme: destination worker ``w`` owns local slots [0, n_loc);
block ``b`` of ``w`` covers local slots [b*nb, (b+1)*nb).  Global block id
= w * B_per_w + b, so a block never spans two workers and per-(source,
block) hit counts reproduce the paper's combined-message metric exactly
(distinct (source worker, destination vertex) pairs).  Oversized groups
span several rows of one segment; the rows are merged with the combine op
before counting, so splitting never double-counts a destination.

Two runtime paths:

* ``combine_with_plan`` — static targets (the broadcast/mirror channels):
  packed rows -> kernel -> segment merge -> global block scatter.
* ``combine_sorted`` — runtime targets: per-row stable sort + segmented
  reduce + one flat (n_pad,) scatter.

Payloads are scalar, one value per lane, or feature-blocked with ONE
trailing feature axis ``(..., F)`` (``feat_mask``/``feat_shape``).  A
feature-blocked plan combine runs in row chunks (``vec_chunk_rows``): each
chunk's lanes are computed from an ``EdgeMap`` (the edge maps composed,
never a whole ``(E, F)`` array), combined by the vector kernel, and merged
straight into the ``(n_blocks, nb, F)`` inbox by block, so neither the
packed lanes, nor the kernel output, nor the reference's
``(n_segs, nb, F)`` segment buffer exists whole.  At n=4M vertices and
F=64 each of those would be 22-46 GB.

Kernel dispatch (``set_kernel_mode``): ``"auto"`` sends CUDA tensors to the
kernel and CPU tensors to its plain version; ``"kernel"`` always calls the
kernel (CPU tensors then raise); ``"ref"`` always takes the plain version.
The plan's index arrays are uploaded to the device once and cached on the
plan (``device_plan``).

Spans (``repro_torch.tracing``): the loop spans ``plan.combine_with_plan``,
``plan.combine_sorted`` and ``plan.combine_sorted_flat``, with the message
accounting inside them as ``channels.count``; the set-up spans
``plan.build`` (a ``get_plan`` miss) and ``plan.upload`` (a
``device_plan`` miss).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.segment_combine import kernel as sc_kernel
from repro_torch.kernels.segment_combine.ref import (
    segment_combine_blocks_ref, sentinels)
from repro_torch.kernels.worker_count.kernel import worker_count

DEFAULT_NB = 128
DEFAULT_EB = 128
CPU_NB = 32
#: what one chunk of a feature-blocked plan combine may hold: its packed
#: lanes (rows, eb, F) plus the kernel's output (rows, nb, F)
VEC_CHUNK_BYTES = 1 << 30

_MODES = ("auto", "kernel", "ref")
_KERNEL_MODE = "auto"
_REDUCE = {"min": "amin", "max": "amax", "sum": "sum"}


def default_nb(device) -> int:
    """Destination-block width: 128 on the GPU (one output slot per thread
    of the kernel's row, a whole number of warps); 32 on the CPU, as the
    reference uses off the TPU.  The width changes the layout, never the
    results."""
    return DEFAULT_NB if torch.device(device).type == "cuda" else CPU_NB


def set_kernel_mode(mode: str) -> None:
    global _KERNEL_MODE
    if mode not in _MODES:
        raise ValueError(f"unknown kernel mode {mode!r}; use one of {_MODES}")
    _KERNEL_MODE = mode


def identity_of(op: str, dtype: torch.dtype):
    """The channel identity of ``op`` in ``dtype``, as a Python number:
    iinfo bounds for integers (exact for vertex ids), +-inf for floats."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return {"min": info.max, "max": info.min, "sum": 0}[op]
    return {"min": float("inf"), "max": float("-inf"), "sum": 0.0}[op]


def scatter_op(op: str, buf: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """``buf.at[idx].{min,max,add}(vals)`` in place: ``idx`` indexes the
    leading axis of ``buf``, and a 2-D ``vals`` scatters whole rows."""
    idx = idx.long()
    if vals.dim() > 1:
        idx = idx.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return buf.scatter_reduce_(0, idx, vals, _REDUCE[op], include_self=True)


def per_worker(worker: torch.Tensor, counts: torch.Tensor, M: int
               ) -> torch.Tensor:
    """(M,) int64 totals of ``counts`` (bool flags or integer counts) by
    worker id — the reference's ``zeros(M).at[worker].add(counts)``; ids
    outside ``[0, M)`` add nothing.  CUDA tensors go to the worker_count
    kernel, which reads nothing back to the host; CPU tensors to its plain
    version."""
    return worker_count(worker, counts, M)


def scatter_hits(n: int, idx: torch.Tensor, hits: torch.Tensor
                 ) -> torch.Tensor:
    """(n,) bool "did at least one real message land here" from per-lane
    ``hits`` flags: a destination counts when a real message was SENT to
    it, whatever its payload.  Lanes with ``hits`` False may point
    anywhere."""
    buf = torch.zeros(n, dtype=torch.int32, device=idx.device)
    flags = hits.to(torch.int32)
    return scatter_op("max", buf, torch.where(hits, idx.long(), 0),
                      flags) > 0


def feat_mask(mask: torch.Tensor, values: torch.Tensor,
              lane_ndim: int) -> torch.Tensor:
    """Broadcast a lane mask over an optional trailing feature axis.  A
    value array is lane-shaped (``lane_ndim`` axes, one value per lane) or
    carries ONE trailing feature axis ``(..., F)``; scalar inputs get
    ``mask`` unchanged, so the scalar path evaluates exactly what it did
    before vector payloads existed."""
    return mask if values.dim() == lane_ndim else mask[..., None]


def feat_shape(values: torch.Tensor, lane_ndim: int) -> tuple:
    """() for scalar payloads, (F,) for feature-blocked ones."""
    feat = tuple(values.shape[lane_ndim:])
    if len(feat) > 1:
        raise ValueError(f"payloads carry at most one feature axis: "
                         f"{tuple(values.shape)} over {lane_ndim} lane axes")
    return feat


@dataclasses.dataclass(frozen=True)
class EdgeMap:
    """Feature-blocked per-edge payloads, (E, F), described instead of
    held: ``take(e)`` computes the values of the edges ``e`` (an int64
    index tensor of any shape) with a trailing feature axis.  The channels
    build one by composing their edge maps (source gather, relay, mask), so
    a plan combine computes only the lanes of the chunk at hand."""
    take: Callable[[torch.Tensor], torch.Tensor]
    n_edges: int
    feat: int
    dtype: torch.dtype
    device: torch.device

    @classmethod
    def of(cls, values: torch.Tensor) -> "EdgeMap":
        """The map of an (E, F) array that is already in memory."""
        return cls(values.__getitem__, values.shape[0], values.shape[1],
                   values.dtype, values.device)

    def where(self, keep: torch.Tensor, ident) -> "EdgeMap":
        """Edges with ``keep`` (E,) False carry ``ident`` in every
        feature."""
        take = self.take
        return dataclasses.replace(self, take=lambda e: torch.where(
            keep[e][..., None], take(e), ident))

    def materialize(self) -> torch.Tensor:
        return self.take(torch.arange(self.n_edges, device=self.device))


Payload = Union[torch.Tensor, EdgeMap]


@dataclasses.dataclass
class EdgePlan:
    """Packed destination-blocked layout of one edge set (host numpy).

    Rows are (eb,)-wide slices of one (source worker, destination block)
    segment; ``row_gather`` indexes the *flattened* per-edge value array.
    """
    M_src: int
    M_dst: int
    n_loc: int
    nb: int
    eb: int
    B_per_w: int               # destination blocks per worker
    n_blocks: int              # M_dst * B_per_w
    n_segs: int
    n_rows: int
    row_gather: np.ndarray     # (n_rows, eb) int32 -> flat edge index
    row_valid: np.ndarray      # (n_rows, eb) bool
    row_local: np.ndarray      # (n_rows, eb) int32 dst-in-block, pad -1
    row_seg: np.ndarray        # (n_rows,) int32 -> segment
    seg_blk: np.ndarray        # (n_segs,) int32 global block id
    seg_worker: np.ndarray     # (n_segs,) int32 source worker
    # device copies, one upload per device (see ``device_plan``)
    device_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                           compare=False)


@dataclasses.dataclass
class DevicePlan:
    """A plan's index arrays on one device, in the dtypes the runtime
    indexes with."""
    row_gather: torch.Tensor   # (n_rows, eb) int64
    row_valid: torch.Tensor    # (n_rows, eb) bool
    row_local: torch.Tensor    # (n_rows, eb) int32 (the kernel's idx)
    row_seg: torch.Tensor      # (n_rows,) int64
    row_blk: torch.Tensor      # (n_rows,) int64 global block of each row
    seg_blk: torch.Tensor      # (n_segs,) int64
    seg_worker: torch.Tensor   # (n_segs,) int64
    gather_max: int            # largest flat edge index a row reads


def device_plan(plan: EdgePlan, device) -> DevicePlan:
    """Upload ``plan``'s index arrays to ``device`` once; later calls
    return the cached copy.  "cuda" and the current card's "cuda:<i>"
    are one device, and so one copy."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    dp = plan.device_cache.get(key)
    if dp is None:
        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), device=device
                                   ).to(dtype)
        with tracing.setup_span("plan.upload", device=key,
                                rows=plan.n_rows):
            seg_blk = up(plan.seg_blk, torch.int64)
            row_seg = up(plan.row_seg, torch.int64)
            dp = DevicePlan(
                row_gather=up(plan.row_gather, torch.int64),
                row_valid=up(plan.row_valid, torch.bool),
                row_local=up(plan.row_local, torch.int32),
                row_seg=row_seg,
                row_blk=seg_blk[row_seg],
                seg_blk=seg_blk,
                seg_worker=up(plan.seg_worker, torch.int64),
                gather_max=(int(plan.row_gather.max()) if plan.n_rows
                            else -1))
        plan.device_cache[key] = dp
    return dp


def build_edge_plan(dst_worker: np.ndarray, dst_local: np.ndarray,
                    mask: np.ndarray, M_dst: int, n_loc: int,
                    nb: int = DEFAULT_NB,
                    eb: Optional[int] = None) -> EdgePlan:
    """dst_worker/dst_local/mask: (M_src, E) host arrays (padded layout).

    ``eb`` (row width) defaults to adapting to the segment-size
    distribution: the p90 segment size rounded up to a power of two in
    [8, DEFAULT_EB*4]; oversized segments span several rows."""
    dst_worker = np.asarray(dst_worker)
    dst_local = np.asarray(dst_local)
    mask = np.asarray(mask)
    M_src, E = dst_worker.shape

    keep = mask.reshape(-1)
    flat_idx = np.flatnonzero(keep).astype(np.int64)
    src_w = flat_idx // max(E, 1)
    return _pack_edge_plan(flat_idx, src_w,
                           dst_worker.reshape(-1)[flat_idx],
                           dst_local.reshape(-1)[flat_idx],
                           M_src, M_dst, n_loc, nb, eb)


def build_edge_plan_flat(src_worker: np.ndarray, dst_worker: np.ndarray,
                         dst_local: np.ndarray, M_src: int, M_dst: int,
                         n_loc: int, nb: int = DEFAULT_NB,
                         eb: Optional[int] = None) -> EdgePlan:
    """CSR-layout twin of ``build_edge_plan``: flat (E,) edge arrays with
    explicit per-edge source workers, no padding mask."""
    src_worker = np.asarray(src_worker, np.int64)
    flat_idx = np.arange(len(src_worker), dtype=np.int64)
    return _pack_edge_plan(flat_idx, src_worker,
                           np.asarray(dst_worker, np.int64),
                           np.asarray(dst_local, np.int64),
                           M_src, M_dst, n_loc, nb, eb)


def _pack_edge_plan(flat_idx: np.ndarray, src_w: np.ndarray,
                    dst_worker: np.ndarray, dst_local: np.ndarray,
                    M_src: int, M_dst: int, n_loc: int, nb: int,
                    eb: Optional[int]) -> EdgePlan:
    """Shared packer: per-kept-edge flat value index + (source worker,
    destination worker/local) -> destination-blocked rows."""
    B_per_w = max(-(-n_loc // nb), 1)
    n_blocks = M_dst * B_per_w
    blk = dst_worker * B_per_w + dst_local // nb
    loc_in_blk = dst_local % nb

    key = src_w * n_blocks + blk
    order = np.argsort(key, kind="stable")
    skey = key[order]
    n_kept = len(skey)

    if n_kept == 0:
        eb = eb or DEFAULT_EB
        return EdgePlan(M_src, M_dst, n_loc, nb, eb, B_per_w, n_blocks,
                        0, 0, np.zeros((0, eb), np.int32),
                        np.zeros((0, eb), bool),
                        np.zeros((0, eb), np.int32),
                        np.zeros((0,), np.int32),
                        np.zeros((0,), np.int32),
                        np.zeros((0,), np.int32))

    first = np.concatenate([[True], skey[1:] != skey[:-1]])
    seg_of = np.cumsum(first) - 1                       # per kept edge
    n_segs = int(seg_of[-1]) + 1
    seg_key = skey[first]
    seg_start = np.flatnonzero(first)
    seg_count = np.diff(np.append(seg_start, n_kept))
    pos = np.arange(n_kept) - seg_start[seg_of]         # rank within segment

    if eb is None:
        p90 = int(np.percentile(seg_count, 90))
        eb = 8
        while eb < p90 and eb < DEFAULT_EB * 4:
            eb *= 2

    seg_nrows = -(-seg_count // eb)
    seg_row0 = np.concatenate([[0], np.cumsum(seg_nrows)[:-1]])
    n_rows = int(seg_nrows.sum())
    row_of = seg_row0[seg_of] + pos // eb
    col_of = pos % eb

    row_gather = np.zeros((n_rows, eb), np.int32)
    row_valid = np.zeros((n_rows, eb), bool)
    row_local = np.full((n_rows, eb), -1, np.int32)
    slot = row_of * eb + col_of
    row_gather.reshape(-1)[slot] = flat_idx[order]
    row_valid.reshape(-1)[slot] = True
    row_local.reshape(-1)[slot] = loc_in_blk[order]

    row_seg = np.repeat(np.arange(n_segs, dtype=np.int32),
                        seg_nrows.astype(np.int64))
    return EdgePlan(
        M_src, M_dst, n_loc, nb, eb, B_per_w, n_blocks, n_segs, n_rows,
        row_gather, row_valid, row_local, row_seg,
        (seg_key % n_blocks).astype(np.int32),
        (seg_key // n_blocks).astype(np.int32))


def _combine_rows(packed: torch.Tensor, row_local: torch.Tensor, op: str,
                  nb: int) -> torch.Tensor:
    """Dispatch one (n_rows, eb[, F]) -> (n_rows, nb[, F]) block
    combine."""
    if _KERNEL_MODE == "ref":
        out = segment_combine_blocks_ref(packed, row_local, op, nb)
    elif _KERNEL_MODE == "kernel":
        launch = sc_kernel.launch_vec if packed.dim() == 3 else sc_kernel.launch
        out = launch(packed, row_local, op, nb)
    else:
        out = sc_kernel.segment_combine_blocks(packed, row_local, op, nb)
    # The kernel's float min/max identities are finite sentinels; map
    # no-hit slots back to the channel identities (+-inf) so the combined
    # blocks compare exactly against the dense path.  Integer blocks
    # already use iinfo bounds == the channel identities.
    if packed.dtype.is_floating_point:
        neg, pos = sentinels(packed.dtype)
        if op == "min":
            out = torch.where(out >= pos, float("inf"), out)
        elif op == "max":
            out = torch.where(out <= neg, float("-inf"), out)
    return out


def combine_rows_subset(plan: EdgePlan, flat_vals: torch.Tensor,
                        rows: torch.Tensor, rows_ok: torch.Tensor,
                        op: str, dp=None) -> torch.Tensor:
    """Combine one subset of plan rows (a pipeline chunk): gather the rows'
    packed lanes and run the same dispatched block combine as the
    whole-plan path.  ``rows_ok`` masks padded chunk slots (their lanes
    combine to the op identity).  ``flat_vals`` is (E,) or (E, F).  ``dp``
    holds the plan's index arrays on the device where the caller has them
    already (the sharded executor's rank plan); by default they are
    uploaded from ``plan``."""
    feat_shape(flat_vals, 1)
    if dp is None:
        dp = device_plan(plan, flat_vals.device)
    rows = rows.long()
    ident = identity_of(op, flat_vals.dtype)
    valid = rows_ok[:, None] & dp.row_valid[rows]
    gathered = flat_vals[dp.row_gather[rows]]
    packed = torch.where(feat_mask(valid, gathered, 2), gathered, ident)
    rloc = torch.where(valid, dp.row_local[rows], -1)
    return _combine_rows(packed, rloc, op, plan.nb)


def plan_seg_hits(plan: EdgePlan, flat_hits: torch.Tensor) -> torch.Tensor:
    """(n_segs, nb) bool: did >= 1 real (masked-in) message land in each
    per-(source, block) destination slot?  The mask-driven twin of the
    value combine (counting by ``combined != identity`` would drop genuine
    messages whose payload equals the identity).  Rides the same block
    combine as the values: max over 0/1 int32 lanes."""
    dp = device_plan(plan, flat_hits.device)
    hitp = (dp.row_valid & flat_hits[dp.row_gather]).to(torch.int32)
    rh = _combine_rows(hitp, dp.row_local, "max", plan.nb)
    sh = torch.zeros((plan.n_segs, plan.nb), dtype=torch.int32,
                     device=flat_hits.device)
    return scatter_op("max", sh, dp.row_seg, rh) > 0


def vec_chunk_rows(plan: EdgePlan, F: int, itemsize: int = 4) -> int:
    """Plan rows one chunk of an F-wide combine takes: its packed lanes
    and kernel output stay within ``VEC_CHUNK_BYTES``."""
    return max(1, VEC_CHUNK_BYTES // ((plan.eb + plan.nb) * F * itemsize))


def vec_chunks(plan: EdgePlan, F: int, itemsize: int = 4) -> int:
    """Chunks (vector kernel launches) of one F-wide combine of ``plan``."""
    return -(-plan.n_rows // vec_chunk_rows(plan, F, itemsize))


def _combine_plan_vec(plan: EdgePlan, dp: DevicePlan, values: EdgeMap,
                      op: str) -> torch.Tensor:
    """The feature-blocked plan combine, chunk by chunk: a chunk's lanes
    come from ``values``, its (rows, nb, F) blocks from the kernel, and
    they merge straight into the (n_blocks, nb, F) inbox by block.  Rows
    are independent in the kernel, so min/max equal the whole-plan
    combine bitwise; sums merge rows in another order than the
    reference's segment-then-block scatter."""
    ident = identity_of(op, values.dtype)
    glob = torch.full((plan.n_blocks, plan.nb, values.feat), ident,
                      dtype=values.dtype, device=values.device)
    itemsize = torch.empty((), dtype=values.dtype).element_size()
    step = vec_chunk_rows(plan, values.feat, itemsize)
    for r0 in range(0, plan.n_rows, step):
        rows = slice(r0, r0 + step)
        packed = torch.where(dp.row_valid[rows][..., None],
                             values.take(dp.row_gather[rows]), ident)
        out = _combine_rows(packed, dp.row_local[rows], op, plan.nb)
        del packed
        scatter_op(op, glob, dp.row_blk[rows], out)
    return glob.view(plan.M_dst, plan.B_per_w * plan.nb,
                     values.feat)[:, :plan.n_loc]


@tracing.traced("plan.combine_with_plan")
def combine_with_plan(plan: EdgePlan, flat_vals: Payload, op: str,
                      count_cross: bool = True,
                      log_of: Optional[np.ndarray] = None,
                      M_out: Optional[int] = None,
                      flat_hits: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Combine per-edge values (flattened (M_src*E,), or feature-blocked
    (M_src*E, F) as an array or an ``EdgeMap``) into a (M_dst, n_loc[, F])
    inbox.  Returns (inbox, (msgs_combined, per_worker_combined) | None):
    the paper's combined-message metric, distinct (source worker,
    destination vertex) pairs that received at least one real message
    (``flat_hits``, the runtime send mask), destination owned by another
    worker.  ``log_of`` maps the physical shards of a split partition back
    to the ``M_out`` logical workers."""
    if isinstance(flat_vals, torch.Tensor) and flat_vals.dim() == 2:
        flat_vals = EdgeMap.of(flat_vals)
    vector = isinstance(flat_vals, EdgeMap)
    if not vector and flat_vals.dim() != 1:
        raise ValueError("pass per-edge values flattened: (E,) or "
                         f"feature-blocked (E, F), got "
                         f"{tuple(flat_vals.shape)}")
    device = flat_vals.device
    n_edges = flat_vals.n_edges if vector else flat_vals.shape[0]
    feat = (flat_vals.feat,) if vector else ()
    M_out = M_out if M_out is not None else plan.M_src
    ident = identity_of(op, flat_vals.dtype)
    if plan.n_rows == 0:
        inbox = torch.full((plan.M_dst, plan.n_loc) + feat, ident,
                           dtype=flat_vals.dtype, device=device)
        if count_cross:
            return inbox, (torch.zeros((), dtype=torch.int64, device=device),
                           torch.zeros(M_out, dtype=torch.int64,
                                       device=device))
        return inbox, None
    dp = device_plan(plan, device)
    if dp.gather_max >= n_edges:
        raise ValueError("plan does not match this edge set: it reads edge "
                         f"{dp.gather_max} of {n_edges}")

    if vector:
        inbox = _combine_plan_vec(plan, dp, flat_vals, op)
    else:
        packed = torch.where(dp.row_valid, flat_vals[dp.row_gather], ident)
        row_out = _combine_rows(packed, dp.row_local, op, plan.nb)

        seg_buf = torch.full((plan.n_segs, plan.nb), ident,
                             dtype=flat_vals.dtype, device=device)
        seg_out = scatter_op(op, seg_buf, dp.row_seg, row_out)
        glob = torch.full((plan.n_blocks, plan.nb), ident,
                          dtype=flat_vals.dtype, device=device)
        glob = scatter_op(op, glob, dp.seg_blk, seg_out)
        inbox = glob.view(plan.M_dst,
                          plan.B_per_w * plan.nb)[:, :plan.n_loc]

    stats = None
    if count_cross:
        if flat_hits is None:
            raise ValueError("count_cross=True needs the per-lane send "
                             "mask (flat_hits)")
        with tracing.span("channels.count"):
            seg_log = dp.seg_worker
            if log_of is not None:
                seg_log = torch.as_tensor(np.asarray(log_of), device=device
                                          ).long()[seg_log]
            owner = dp.seg_blk // plan.B_per_w
            cross = (plan_seg_hits(plan, flat_hits)
                     & (owner != seg_log)[:, None])
            per_seg = cross.sum(dim=1)
            stats = (per_seg.sum(), per_worker(seg_log, per_seg, M_out))
    return inbox, stats


# ---------------------------------------------------------------------------
# dynamic targets: sorted segmented combine (no precomputation possible)
# ---------------------------------------------------------------------------

def _segment_reduce(op: str, values: torch.Tensor, seg_id: torch.Tensor,
                    num: int) -> torch.Tensor:
    """``jax.ops.segment_{min,max,sum}``: empty segments hold the op's
    identity (dtype max for min, dtype min for max, 0 for sum).
    ``values`` is (N,) or (N, F)."""
    buf = torch.full((num,) + tuple(values.shape[1:]),
                     identity_of(op, values.dtype), dtype=values.dtype,
                     device=values.device)
    return scatter_op(op, buf, seg_id, values)


def sorted_segments(targets: torch.Tensor, values: torch.Tensor,
                    mask: torch.Tensor, op: str, n_pad: int):
    """Per-row stable sort + segmented reduce of runtime (R, K) target
    rows.  Returns ``(real, seg_t, seg_val, seg_row, ident)``: for every
    live (row, distinct target) segment its validity, target, combined
    value and source row.  ``values`` is (R, K) or (R, K, F)."""
    ident = identity_of(op, values.dtype)
    feat = feat_shape(values, 2)
    R, K = targets.shape
    t = torch.where(mask, targets, n_pad)        # sentinel sorts last
    order = torch.argsort(t, dim=1, stable=True)
    ts = torch.gather(t, 1, order)
    vs = torch.gather(torch.where(feat_mask(mask, values, 2), values, ident),
                      1, feat_mask(order, values, 2).expand(values.shape))

    first = torch.cat([torch.ones((R, 1), dtype=torch.bool,
                                  device=t.device),
                       ts[:, 1:] != ts[:, :-1]], dim=1)
    seg_id = torch.cumsum(first.reshape(-1), 0) - 1
    seg_val = _segment_reduce(op, vs.reshape((R * K,) + feat), seg_id,
                              R * K)
    seg_t = _segment_reduce("min", ts.reshape(-1), seg_id, R * K)
    rows = torch.arange(R, dtype=torch.int32, device=t.device
                        )[:, None].expand(R, K)
    seg_row = _segment_reduce("min", rows.reshape(-1), seg_id, R * K)
    live = torch.zeros(R * K, dtype=torch.bool, device=t.device)
    live[seg_id] = True
    real = live & (seg_t < n_pad)
    return real, seg_t, seg_val, seg_row, ident


def _flat_combine(real: torch.Tensor, seg_t: torch.Tensor,
                  seg_val: torch.Tensor, seg_w: torch.Tensor, op: str,
                  ident, M: int, n_loc: int):
    """One flat (n_pad,) scatter of the per-segment combined values, plus
    the mask-driven crossness of the segments (a live segment IS >= 1 real
    message, whatever its combined value)."""
    n_pad = M * n_loc
    feat = feat_shape(seg_val, 1)
    buf = torch.full((n_pad,) + feat, ident, dtype=seg_val.dtype,
                     device=seg_val.device)
    buf = scatter_op(op, buf, torch.where(real, seg_t, 0),
                     torch.where(feat_mask(real, seg_val, 1), seg_val,
                                 ident))
    with tracing.span("channels.count"):
        cross = real & (torch.div(seg_t, n_loc, rounding_mode="floor")
                        != seg_w)
        counts = (cross.sum(), per_worker(seg_w, cross, M))
    return buf.view((M, n_loc) + feat), counts


@tracing.traced("plan.combine_sorted")
def combine_sorted(targets: torch.Tensor, values: torch.Tensor,
                   mask: torch.Tensor, op: str, M: int, n_loc: int
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Sender-side combine for runtime target arrays (M, K): sort each
    worker's targets, reduce duplicate targets, then one flat scatter into
    a single (n_pad,) buffer.  Returns (inbox (M, n_loc), (msgs_combined,
    per_worker_combined)), counts identical to the dense path."""
    real, seg_t, seg_val, seg_row, ident = sorted_segments(
        targets, values, mask, op, M * n_loc)
    return _flat_combine(real, seg_t, seg_val, seg_row, op, ident, M, n_loc)


def sort_by_worker_target(worker: torch.Tensor, t: torch.Tensor):
    """Two-pass stable sort of flat (E,) pairs by (worker, target) — no
    ``worker * n_pad + target`` composite key that could overflow int32.
    Returns (order, sorted worker, sorted target, first-of-segment mask);
    a segment is one distinct (worker, target) pair."""
    order1 = torch.argsort(t, stable=True)
    order = order1[torch.argsort(worker[order1], stable=True)]
    ws, ts = worker[order], t[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=t.device),
                       (ws[1:] != ws[:-1]) | (ts[1:] != ts[:-1])])
    return order, ws, ts, first


def sorted_segments_flat(targets: torch.Tensor, values: torch.Tensor,
                         mask: torch.Tensor, src_worker: torch.Tensor,
                         op: str, n_pad: int):
    """Flat-(E,) twin of ``sorted_segments``: sort by (worker, target),
    segmented reduce.  Returns ``(real, seg_t, seg_val, seg_w, ident)``,
    one entry per distinct live (source worker, target) pair.  ``values``
    is (E,) or (E, F)."""
    ident = identity_of(op, values.dtype)
    feat_shape(values, 1)
    E = targets.shape[0]
    t = torch.where(mask, targets, n_pad)        # sentinel sorts last
    order, ws, ts, first = sort_by_worker_target(src_worker, t)
    vs = torch.where(feat_mask(mask, values, 1), values, ident)[order]

    seg_id = torch.cumsum(first, 0) - 1
    seg_val = _segment_reduce(op, vs, seg_id, E)
    seg_t = _segment_reduce("min", ts, seg_id, E)
    seg_w = _segment_reduce("min", ws, seg_id, E)
    live = torch.zeros(E, dtype=torch.bool, device=t.device)
    live[seg_id] = True
    real = live & (seg_t < n_pad)
    return real, seg_t, seg_val, seg_w, ident


@tracing.traced("plan.combine_sorted_flat")
def combine_sorted_flat(targets: torch.Tensor, values: torch.Tensor,
                        mask: torch.Tensor, src_worker: torch.Tensor,
                        op: str, M: int, n_loc: int,
                        log_of: Optional[np.ndarray] = None
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                       torch.Tensor]]:
    """CSR twin of ``combine_sorted``: flat (E,) targets/values/mask with
    explicit per-edge source workers.  With a split partition
    ``src_worker`` holds physical shard ids and ``log_of`` maps them to the
    (M,) logical workers for crossness and the per-worker report."""
    ident = identity_of(op, values.dtype)
    device = values.device
    if targets.shape[0] == 0:
        return (torch.full((M, n_loc) + feat_shape(values, 1), ident,
                           dtype=values.dtype, device=device),
                (torch.zeros((), dtype=torch.int64, device=device),
                 torch.zeros(M, dtype=torch.int64, device=device)))
    real, seg_t, seg_val, seg_w, ident = sorted_segments_flat(
        targets, values, mask, src_worker, op, M * n_loc)
    seg_log = seg_w.long()
    if log_of is not None:
        seg_log = torch.as_tensor(np.asarray(log_of), device=device
                                  ).long()[torch.where(real, seg_log, 0)]
    return _flat_combine(real, seg_t, seg_val, seg_log, op, ident, M, n_loc)


# ---------------------------------------------------------------------------
# plan cache keyed on the partitioned graph
# ---------------------------------------------------------------------------

def get_plan(pg, kind: str, nb: Optional[int] = None,
             eb: Optional[int] = None) -> EdgePlan:
    """Lazily build (and memoize on ``pg``) the plan for one edge set:
    ``eg`` (Ch_msg, non-mirrored sources), ``all`` (full adjacency), or
    ``mir`` (mirror fan-out, destinations local to the hosting worker).
    Plans are packed from the partition's host numpy arrays."""
    cache: Dict = pg.plan_cache
    nb = nb or default_nb(pg.device)
    key = (kind, nb, eb)
    if key in cache:
        return cache[key]
    if kind not in ("eg", "all", "mir"):
        raise ValueError(f"unknown plan kind: {kind!r}")
    with tracing.setup_span("plan.build", kind=kind):
        plan = _build_plan(pg, kind, nb, eb)
    cache[key] = plan
    return plan


def _build_plan(pg, kind: str, nb: int, eb: Optional[int]) -> EdgePlan:
    """Pack the plan of one edge set from the partition's host arrays."""
    h = pg.host
    if pg.layout == "csr":
        # flat edges feed the packer directly.  A split partition combines
        # per *physical shard*: the plan's source-worker axis becomes the
        # shard id (callers fold stats back through pg.phys_log).
        split = pg.phys_log is not None
        M_src = pg.M_phys if split else pg.M
        if kind in ("eg", "all"):
            src = h[f"{kind}_src"]
            dst = h[f"{kind}_dst"]
            sw = h[f"{kind}_pw"] if split else src // pg.n_loc
        else:
            # mirror fan-out is local: source worker == hosting worker
            dst = h["mir_edst"]
            sw = h["mir_pw"] if split else dst // pg.n_loc
        return build_edge_plan_flat(sw, dst // pg.n_loc, dst % pg.n_loc,
                                    M_src, pg.M, pg.n_loc, nb, eb)
    if kind in ("eg", "all"):
        dst = h[f"{kind}_dst"]
        return build_edge_plan(dst // pg.n_loc, dst % pg.n_loc,
                               h[f"{kind}_mask"], pg.M, pg.n_loc, nb, eb)
    edst = h["mir_edst"]
    own = np.broadcast_to(np.arange(pg.M)[:, None], edst.shape)
    return build_edge_plan(own, edst, h["mir_emask"], pg.M, pg.n_loc, nb,
                           eb)
