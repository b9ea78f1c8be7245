"""Graph containers and the worker-partitioned representation, on torch.

The counterpart of ``repro.graph.structs``.  Partitioning is host work:
the numpy below is the reference's, line for line, so the same graph and
seed give the same relabeling and the same edge arrays.  Only the
boundary differs: where the reference calls ``jnp.asarray`` on each field,
the port calls ``torch.as_tensor(..., device=device)`` and keeps the numpy
array beside the tensor (``PartitionedGraph.host``), because the message
plans (``core/plan.py``) are packed on the host from those arrays and
``np.asarray`` cannot read a CUDA tensor.

The engine executes the paper's per-worker logic as batched tensor ops over
a leading worker axis ``M`` (exact M-worker simulation and exact message
counts on one device).

Two edge layouts (``partition(..., layout=...)``):

* ``"padded"`` — per-worker edge rows padded to the hottest worker's
  length, ``(M, E_hot)`` arrays.
* ``"csr"`` — flat ``(E,)`` edge arrays plus per-worker ``(M+1,)`` row
  offsets (``eg_off``/``all_off``/``mir_eoff``).  ``eg_src``/``all_src``
  hold *global* source slot ids and ``mir_edst`` *global* destination ids
  (the worker of an id is ``id // n_loc``).

Vertex ids are relabeled at partition time and block-partitioned:
``owner(v) = v // n_loc``.  The relabeling is the load-balancing knob,
resolved through ``graph/partitioner.py`` (``hash``, ``edges``,
``edges+refine``, ``split`` and ``vertex-cut``; see that module).

Streaming mutations (``EdgeDelta``, ``apply_delta``, ``fold_delta``): the
graph service's edge deltas, folded into a csr partition on the host
without a new ``partition()`` (the relabeling, ``n_loc``, ``tau`` and
``vmask`` stay; the padded layout and ``balance="split"`` are rebuilt
under the pinned ``perm``).  The numpy is the reference's; the folded
partition's arrays are placed on the partition's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import cost_model
from repro_torch.graph import partitioner as partitioner_mod
from repro_torch.graph.partitioner import BALANCES  # noqa: F401 (re-export)

LAYOUTS = ("padded", "csr")

#: fields that live on the device (tensors); the optional ones are None
#: unless the partition is split (balance="split")
ARRAY_FIELDS = ("eg_src", "eg_dst", "eg_mask", "eg_w",
                "all_src", "all_dst", "all_mask", "all_w",
                "mir_ids", "mir_slot_of", "mir_nworkers", "mir_esrc",
                "mir_edst", "mir_emask", "mir_ew", "deg", "vmask",
                "eg_pw", "all_pw", "mir_pw")
#: host numpy fields (offsets, relabeling, caps) and plain scalars
HOST_FIELDS = ("perm", "inv_perm", "eg_off", "all_off", "mir_eoff",
               "phys_log", "phys_eg_off", "phys_all_off", "phys_mir_off",
               "pair_counts")
SCALAR_FIELDS = ("n", "M", "n_loc", "tau", "layout", "balance",
                 "split_factor", "M_phys", "hosts")

DeviceLike = Union[str, torch.device]


def resolve_device(device: Optional[DeviceLike] = "cuda") -> torch.device:
    """The device an entry point runs on.  The port runs on the card: a
    CUDA device without CUDA raises instead of falling back to the CPU,
    which the caller must ask for with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; the port runs on the "
            'GPU by default; pass device="cpu" to run on the CPU')
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class Graph:
    """Host-side graph: COO edge list (directed; undirected graphs store both
    directions)."""
    n: int
    src: np.ndarray  # (E,) int64
    dst: np.ndarray  # (E,) int64
    weight: Optional[np.ndarray] = None  # (E,) float32

    @property
    def m(self) -> int:
        return len(self.src)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n)

    def symmetrized(self) -> "Graph":
        """Both directions, deduplicated; undirected weights canonicalized
        to the min over the two directions (so w(a,b) == w(b,a))."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        w = None if self.weight is None else np.concatenate([self.weight] * 2)
        key = src.astype(np.int64) * self.n + dst
        order = np.argsort(key, kind="stable")
        key_s, src_s, dst_s = key[order], src[order], dst[order]
        first = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        src_u, dst_u = src_s[first], dst_s[first]
        if w is None:
            return Graph(self.n, src_u, dst_u, None)
        wmin_dir = np.minimum.reduceat(w[order], np.flatnonzero(first))
        lo = np.minimum(src_u, dst_u)
        hi = np.maximum(src_u, dst_u)
        ukey = lo.astype(np.int64) * self.n + hi
        _, inv = np.unique(ukey, return_inverse=True)
        wpair = np.full(inv.max() + 1, np.inf, np.float32)
        np.minimum.at(wpair, inv, wmin_dir.astype(np.float32))
        return Graph(self.n, src_u, dst_u, wpair[inv].astype(np.float32))


@dataclasses.dataclass
class PartitionedGraph:
    """M-worker partition with the paper's two channels precomputed.

    Low-degree (< tau) vertices' edges go through Ch_msg (COO per worker);
    high-degree vertices are *mirrored*: their value is broadcast once per
    hosting worker and fanned out locally through the mirror COO.

    The array fields are tensors on one device with the reference's device
    dtypes; ``host`` holds the same arrays as numpy (the plan packer reads
    those).  See ``repro.graph.structs.PartitionedGraph`` for each field.
    """
    n: int
    M: int
    n_loc: int
    tau: int
    perm: np.ndarray          # relabel: new_id = perm[old_id]
    inv_perm: np.ndarray

    # Ch_msg edges (from non-mirrored sources):
    eg_src: torch.Tensor      # (M, E_loc) local src slot | (E_lo,) global
    eg_dst: torch.Tensor      # (M, E_loc) global dst id (pad: 0) | (E_lo,)
    eg_mask: torch.Tensor     # (M, E_loc) bool | (E_lo,) all-True
    eg_w: torch.Tensor        # (M, E_loc) float32 | (E_lo,)

    # full adjacency (mirrored + not):
    all_src: torch.Tensor     # (M, A_loc) | (E,) global
    all_dst: torch.Tensor
    all_mask: torch.Tensor
    all_w: torch.Tensor

    # mirror structures:
    mir_ids: torch.Tensor     # (n_mir,) mirrored vertex ids (pad n_pad)
    mir_slot_of: torch.Tensor  # (M, n_loc) index into mir_ids or -1
    mir_nworkers: torch.Tensor  # (n_mir,) #workers holding a mirror (Thm 1)
    mir_esrc: torch.Tensor    # (M, ME_loc) index into mir_ids | (ME,)
    mir_edst: torch.Tensor    # (M, ME_loc) local dst slot | (ME,) global dst
    mir_emask: torch.Tensor   # (M, ME_loc) | (ME,) all-True
    mir_ew: torch.Tensor      # (M, ME_loc) | (ME,)

    deg: torch.Tensor         # (M, n_loc) out-degree
    vmask: torch.Tensor       # (M, n_loc) real-vertex mask

    layout: str = "padded"
    # csr row offsets (host numpy, (M+1,) int64); None in padded layout:
    eg_off: Optional[np.ndarray] = None
    all_off: Optional[np.ndarray] = None
    mir_eoff: Optional[np.ndarray] = None

    balance: str = "hash"
    split_factor: float = 1.2
    # physical worker axis (balance="split"): M_phys == M and phys_log is
    # None otherwise
    M_phys: int = 0
    phys_log: Optional[np.ndarray] = None      # (M_phys,) logical worker
    phys_eg_off: Optional[np.ndarray] = None   # (M_phys+1,) refined offsets
    phys_all_off: Optional[np.ndarray] = None
    phys_mir_off: Optional[np.ndarray] = None
    eg_pw: Optional[torch.Tensor] = None       # per-edge physical shard ids
    all_pw: Optional[torch.Tensor] = None
    mir_pw: Optional[torch.Tensor] = None

    # (M, M) distinct (source worker, destination vertex) pair counts
    pair_counts: Optional[np.ndarray] = None
    hosts: Optional[int] = None

    # numpy copies of the array fields, and the lazily built message plans
    # (core/plan.py) keyed (kind, nb, eb); never part of equality
    host: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)
    plan_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def n_pad(self) -> int:
        return self.M * self.n_loc

    @property
    def device(self) -> torch.device:
        return self.vmask.device

    def edge_load(self, phys: bool = False) -> np.ndarray:
        """Per-worker edge load: Ch_msg edges stored at the source worker
        plus mirror fan-out edges at the hosting worker.  ``phys=True``
        returns the per-physical-shard loads of a split partition."""
        if self.layout == "csr":
            if phys and self.phys_log is not None:
                return (np.diff(self.phys_eg_off)
                        + np.diff(self.phys_mir_off))
            return np.diff(self.eg_off) + np.diff(self.mir_eoff)
        return (self.host["eg_mask"].sum(axis=1)
                + self.host["mir_emask"].sum(axis=1)).astype(np.int64)

    def local_ids(self) -> torch.Tensor:
        """(M, n_loc) int64 global id of each local slot."""
        return torch.arange(self.n_pad, device=self.device).view(
            self.M, self.n_loc)

    # -- global reductions (one device: plain reductions) ------------------
    def gany(self, x: torch.Tensor) -> torch.Tensor:
        return torch.any(x)

    def gall(self, x: torch.Tensor) -> torch.Tensor:
        return torch.all(x)

    def gsum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x)

    def gmax(self, x: torch.Tensor) -> torch.Tensor:
        return torch.max(x)

    def edge_src_values(self, state: torch.Tensor, src: torch.Tensor,
                        kind: Optional[str] = None) -> torch.Tensor:
        """Read per-vertex ``state`` at each edge's (locally stored) source
        endpoint: ``src`` is (M, E_loc) local slots in the padded layout,
        flat (E,) global slot ids in csr.  ``kind`` (the edge set, "all"
        or "eg") is read only by the sharded executor's split rank view."""
        if self.layout == "csr":
            return state.reshape(-1)[src.long()]
        return torch.gather(state, 1, src.long())


def _pad_rows(rows, pad_val, dtype):
    """list of 1-D arrays -> (M, maxlen) + mask."""
    m = max((len(r) for r in rows), default=0)
    m = max(m, 1)
    out = np.full((len(rows), m), pad_val, dtype=dtype)
    mask = np.zeros((len(rows), m), bool)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
        mask[i, :len(r)] = True
    return out, mask


def canonical_labels(pg: PartitionedGraph, labels) -> np.ndarray:
    """Group labels computed in *relabeled* space (e.g. Hash-Min component
    ids) -> per-original-vertex canonical representative: the min ORIGINAL
    id of each group.  Makes results comparable across balance modes."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    flat = np.asarray(labels).reshape(-1)
    lab = flat[pg.perm]
    uniq, inv = np.unique(lab, return_inverse=True)
    rep = np.full(len(uniq), pg.n, np.int64)
    np.minimum.at(rep, inv, np.arange(pg.n))
    return rep[inv]


def _refine_offsets(off: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Split each worker's [off[w], off[w+1]) edge range into k[w] near
    equal parts -> (sum(k)+1,) physical offsets refining ``off``."""
    off = np.asarray(off, np.int64)
    starts = np.repeat(off[:-1], k)
    lens = np.repeat(np.diff(off), k)
    kk = np.repeat(k, k)
    jj = (np.arange(int(k.sum()), dtype=np.int64)
          - np.repeat(np.cumsum(k) - k, k))
    return np.append(starts + (lens * jj) // kk, off[-1])


def from_numpy(fields: dict, device: Optional[DeviceLike] = "cuda"
               ) -> PartitionedGraph:
    """Build a ``PartitionedGraph`` from numpy fields: the array fields
    become tensors on ``device`` (the numpy arrays are kept as ``host``),
    host fields and scalars are taken as they are.  ``fields`` holds every
    name of ``ARRAY_FIELDS``, ``HOST_FIELDS`` and ``SCALAR_FIELDS``; it is
    what ``to_numpy`` returns, or the reference partition's fields read
    with ``np.asarray``."""
    dev = resolve_device(device)
    host = {}
    kw = {}
    for name in ARRAY_FIELDS:
        arr = fields.get(name)
        if arr is None:
            kw[name] = None
            continue
        arr = np.require(arr, requirements=["C", "W"])
        host[name] = arr
        kw[name] = torch.as_tensor(arr, device=dev)
    for name in HOST_FIELDS:
        v = fields.get(name)
        kw[name] = None if v is None else np.asarray(v)
    for name in SCALAR_FIELDS:
        kw[name] = fields[name]
    return PartitionedGraph(host=host, **kw)


def to_numpy(pg: PartitionedGraph) -> dict:
    """The inverse of ``from_numpy``: every array field as numpy, plus the
    host fields and scalars."""
    out = {name: getattr(pg, name) for name in SCALAR_FIELDS + HOST_FIELDS}
    for name in ARRAY_FIELDS:
        out[name] = (None if getattr(pg, name) is None
                     else getattr(pg, name).cpu().numpy())
    return out


def partition(g: Graph, M: int, tau: Optional[int] = None,
              seed: int = 0, layout: str = "padded",
              balance: str = "hash",
              split_factor: float = 1.2,
              hosts: Optional[int] = None,
              perm: Optional[np.ndarray] = None,
              device: Optional[DeviceLike] = "cuda") -> PartitionedGraph:
    """Partition ``g`` over M workers with mirroring threshold ``tau``
    (None => mirroring disabled, i.e. tau = inf), on the host, and place
    the edge arrays on ``device``.

    The arguments are those of ``repro.graph.structs.partition`` (layouts,
    the five balance modes, ``hosts`` placement, a pinned ``perm``), and
    every array comes out equal to the reference's.  ``device`` defaults
    to the GPU and raises where there is none (pass ``device="cpu"``).
    The call is the set-up span ``partition`` (``repro_torch.tracing``),
    its phases the spans ``partition.assign``, ``.relabel``,
    ``.msg_edges``, ``.mirrors``, ``.pair_counts``, ``.split`` and
    ``.upload``.
    """
    with tracing.setup_span("partition"):
        return _partition(g, M, tau, seed, layout, balance, split_factor,
                          hosts, perm, device)


def _partition(g: Graph, M: int, tau: Optional[int], seed: int,
               layout: str, balance: str, split_factor: float,
               hosts: Optional[int], perm: Optional[np.ndarray],
               device: Optional[DeviceLike]) -> PartitionedGraph:
    """``partition``'s body, each phase a set-up span."""
    dev = resolve_device(device)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; use one of {LAYOUTS}")
    if balance not in BALANCES:
        raise ValueError(f"unknown balance {balance!r}; use one of "
                         f"{BALANCES}")
    if balance == "split" and layout != "csr":
        raise ValueError('balance="split" moves csr row-offset boundaries; '
                         'use layout="csr"')
    n_loc = -(-g.n // M)
    pinned_perm = perm is not None
    tau_eff = tau if tau is not None else g.n + 1
    with tracing.setup_span("partition.assign"):
        if pinned_perm:
            # an explicit perm is final: the partitioner layer (and the host
            # regroup) is bypassed, and ``tau`` is the EFFECTIVE threshold
            perm = np.asarray(perm, np.int64)
            if perm.shape != (g.n,):
                raise ValueError(f"perm must have shape ({g.n},), got "
                                 f"{perm.shape}")
        else:
            p9r = partitioner_mod.partitioner_for(
                balance, tau=tau, seed=seed, split_factor=split_factor)
            perm, spec = p9r.assign(g, M, hosts)
            if spec.vc_thresh is not None:
                tau_eff = min(tau_eff, int(spec.vc_thresh))
    with tracing.setup_span("partition.relabel"):
        n_ids = M * n_loc
        inv = np.full(n_ids, -1, np.int64)
        inv[perm] = np.arange(g.n)
        src = perm[g.src]
        dst = perm[g.dst]
        w = g.weight if g.weight is not None else np.ones(g.m, np.float32)

        owner = src // n_loc
        deg = np.bincount(src, minlength=n_ids)
        mirrored = deg >= tau_eff                      # per (new) vertex id

    # ---- Ch_msg edges: sources below threshold -------------------------
    # one stable sort by owner, then per-worker slices
    with tracing.setup_span("partition.msg_edges"):
        lo = ~mirrored[src]
        oorder = np.argsort(owner, kind="stable")
        osrc, odst, ow_, olo = src[oorder], dst[oorder], w[oorder], lo[oorder]
        bounds = np.searchsorted(owner[oorder], np.arange(M + 1))
        if layout == "csr":
            all_src = osrc.astype(np.int32)
            all_dst = odst.astype(np.int32)
            all_w = ow_.astype(np.float32)
            all_mask = np.ones(len(osrc), bool)
            all_off = bounds.astype(np.int64)
            eg_src = osrc[olo].astype(np.int32)
            eg_dst = odst[olo].astype(np.int32)
            eg_w = ow_[olo].astype(np.float32)
            eg_mask = np.ones(len(eg_src), bool)
            eg_off = np.searchsorted(owner[oorder][olo],
                                     np.arange(M + 1)).astype(np.int64)
        else:
            eg_rows_s, eg_rows_d, eg_rows_w = [], [], []
            all_rows_s, all_rows_d, all_rows_w = [], [], []
            for wk in range(M):
                sl = slice(bounds[wk], bounds[wk + 1])
                all_rows_s.append((osrc[sl] % n_loc).astype(np.int32))
                all_rows_d.append(odst[sl].astype(np.int32))
                all_rows_w.append(ow_[sl].astype(np.float32))
                keep = olo[sl]
                eg_rows_s.append((osrc[sl][keep] % n_loc).astype(np.int32))
                eg_rows_d.append(odst[sl][keep].astype(np.int32))
                eg_rows_w.append(ow_[sl][keep].astype(np.float32))
            eg_src, eg_mask = _pad_rows(eg_rows_s, 0, np.int32)
            eg_dst, _ = _pad_rows(eg_rows_d, 0, np.int32)
            eg_w, _ = _pad_rows(eg_rows_w, 0.0, np.float32)
            all_src, all_mask = _pad_rows(all_rows_s, 0, np.int32)
            all_dst, _ = _pad_rows(all_rows_d, 0, np.int32)
            all_w, _ = _pad_rows(all_rows_w, 0.0, np.float32)
            eg_off = all_off = None

    # ---- mirrors: group each high-deg vertex's edges by dst worker -----
    with tracing.setup_span("partition.mirrors"):
        mir_vertex_ids = np.flatnonzero(mirrored)          # sorted global ids
        n_mir = max(len(mir_vertex_ids), 1)
        mir_slot_of = np.full((M, n_loc), -1, np.int32)
        mir_slot_of.reshape(-1)[mir_vertex_ids] = np.arange(
            len(mir_vertex_ids))

        hi = mirrored[src]
        hsrc, hdst, hw = src[hi], dst[hi], w[hi]
        dst_owner = hdst // n_loc
        es_all = np.zeros(0, np.int32)
        edg_all = np.zeros(0, np.int64)                    # global dst ids
        ew_all = np.zeros(0, np.float32)
        hb = np.zeros(M + 1, np.int64)
        nworkers = np.zeros(n_mir, np.int64)
        if len(hsrc):
            # sort once by (dst worker, src, dst), then slice per hosting
            # worker
            order = np.lexsort((hdst, hsrc, dst_owner))
            hsrc, hdst, hw, dst_owner = (hsrc[order], hdst[order], hw[order],
                                         dst_owner[order])
            mir_idx_of = np.full(n_ids, -1, np.int64)
            mir_idx_of[mir_vertex_ids] = np.arange(len(mir_vertex_ids))
            es_all = mir_idx_of[hsrc].astype(np.int32)
            edg_all = hdst.astype(np.int64)
            ew_all = hw.astype(np.float32)
            hb = np.searchsorted(dst_owner, np.arange(M + 1)).astype(np.int64)
            # workers per mirrored vertex
            pair = np.unique(hsrc * np.int64(M) + dst_owner)
            cnt = np.bincount((pair // M).astype(np.int64), minlength=n_ids)
            nworkers = cnt[mir_vertex_ids] if len(mir_vertex_ids) else nworkers
        if layout == "csr":
            mir_esrc = es_all
            mir_edst = edg_all.astype(np.int32)            # global dst ids
            mir_ew = ew_all
            mir_emask = np.ones(len(es_all), bool)
            mir_eoff = hb
        else:
            rows_es = [es_all[hb[ow]:hb[ow + 1]] for ow in range(M)]
            rows_ed = [(edg_all[hb[ow]:hb[ow + 1]] % n_loc).astype(np.int32)
                       for ow in range(M)]
            rows_ew = [ew_all[hb[ow]:hb[ow + 1]] for ow in range(M)]
            mir_esrc, mir_emask = _pad_rows(rows_es, 0, np.int32)
            mir_edst, _ = _pad_rows(rows_ed, 0, np.int32)
            mir_ew, _ = _pad_rows(rows_ew, 0.0, np.float32)
            mir_eoff = None

    deg_pad = deg.astype(np.int32).reshape(M, n_loc)
    vmask = np.zeros((M, n_loc), bool)
    vmask.reshape(-1)[perm] = True

    # per-destination caps: distinct (source worker, destination vertex)
    # pairs per worker pair
    with tracing.setup_span("partition.pair_counts"):
        pkey = np.unique(owner.astype(np.int64) * n_ids + dst)
        pair_counts = np.zeros((M, M), np.int64)
        np.add.at(pair_counts,
                  ((pkey // n_ids).astype(np.int64),
                   ((pkey % n_ids) // n_loc).astype(np.int64)), 1)

    mir_ids_arr = np.full(n_mir, M * n_loc, np.int32)
    mir_ids_arr[:len(mir_vertex_ids)] = mir_vertex_ids

    # ---- hot-worker splitting: physical shard boundaries ---------------
    M_phys, phys_log = M, None
    phys_eg = phys_all = phys_mir = None
    eg_pw = all_pw = mir_pw = None
    with tracing.setup_span("partition.split"):
        if balance == "split":
            load = np.diff(eg_off) + np.diff(hb)
            k = cost_model.choose_split(load, split_factor)
            M_phys = int(k.sum())
            phys_log = np.repeat(np.arange(M, dtype=np.int64), k)
            phys_eg = _refine_offsets(eg_off, k)
            phys_all = _refine_offsets(all_off, k)
            phys_mir = _refine_offsets(hb, k)
            pids = np.arange(M_phys, dtype=np.int32)
            eg_pw = np.repeat(pids, np.diff(phys_eg))
            all_pw = np.repeat(pids, np.diff(phys_all))
            mir_pw = np.repeat(pids, np.diff(phys_mir))
            if len(hsrc):
                # Theorem-1 accounting at shard granularity: a mirrored vertex
                # is broadcast once per *physical shard* hosting its edges
                spair = np.unique(es_all.astype(np.int64) * M_phys + mir_pw)
                nworkers = np.bincount(spair // M_phys, minlength=n_mir)

    # the reference's device arrays are 32-bit (jax_enable_x64 is off), so
    # the one int64 count array crosses the boundary as int32 here too
    with tracing.setup_span("partition.upload"):
        return from_numpy(dict(
            n=g.n, M=M, n_loc=n_loc, tau=int(tau_eff), perm=perm, inv_perm=inv,
            eg_src=eg_src, eg_dst=eg_dst, eg_mask=eg_mask, eg_w=eg_w,
            all_src=all_src, all_dst=all_dst, all_mask=all_mask, all_w=all_w,
            mir_ids=mir_ids_arr, mir_slot_of=mir_slot_of,
            mir_nworkers=nworkers.astype(np.int32),
            mir_esrc=mir_esrc, mir_edst=mir_edst, mir_emask=mir_emask,
            mir_ew=mir_ew, deg=deg_pad, vmask=vmask,
            layout=layout, eg_off=eg_off, all_off=all_off, mir_eoff=mir_eoff,
            balance=balance, split_factor=split_factor, M_phys=M_phys,
            phys_log=phys_log, phys_eg_off=phys_eg, phys_all_off=phys_all,
            phys_mir_off=phys_mir, eg_pw=eg_pw, all_pw=all_pw, mir_pw=mir_pw,
            pair_counts=pair_counts, hosts=hosts), device=dev)


# ---------------------------------------------------------------------------
# Streaming mutations: delta-CSR segments folded into the flat layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EdgeDelta:
    """A streaming mutation batch, in ORIGINAL vertex-id space.

    ``add_*`` are appended as they are (parallel edges allowed, like the
    base edge list); ``rem_*`` remove every stored edge matching the (src,
    dst) pair, whatever its weight.  The vertex-id universe is fixed at
    partition time: deltas may only reference ids < n.
    """
    add_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    add_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    add_w: Optional[np.ndarray] = None
    rem_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    rem_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))

    def symmetrized(self) -> "EdgeDelta":
        """Both directions of every add and removal (for graphs stored
        symmetrized).  No dedup: don't add (u, v) and (v, u) both."""
        w = None if self.add_w is None else np.concatenate([self.add_w] * 2)
        return EdgeDelta(
            add_src=np.concatenate([self.add_src, self.add_dst]),
            add_dst=np.concatenate([self.add_dst, self.add_src]),
            add_w=w,
            rem_src=np.concatenate([self.rem_src, self.rem_dst]),
            rem_dst=np.concatenate([self.rem_dst, self.rem_src]))


def apply_delta(g: Graph, delta: EdgeDelta) -> Graph:
    """Host reference mutation: kept edges in original order, adds
    appended.  ``fold_delta`` on a partition of ``g`` equals
    ``partition(apply_delta(g, delta), ..., perm=pg.perm)``."""
    keep = np.ones(g.m, bool)
    if len(delta.rem_src):
        rkey = (np.asarray(delta.rem_src, np.int64) * g.n
                + np.asarray(delta.rem_dst, np.int64))
        keep = ~np.isin(g.src.astype(np.int64) * g.n + g.dst, rkey)
    a_src = np.asarray(delta.add_src, np.int64)
    a_dst = np.asarray(delta.add_dst, np.int64)
    src = np.concatenate([g.src[keep], a_src])
    dst = np.concatenate([g.dst[keep], a_dst])
    if g.weight is None and delta.add_w is None:
        return Graph(g.n, src, dst, None)
    w_old = (g.weight if g.weight is not None
             else np.ones(g.m, np.float32))
    a_w = (np.asarray(delta.add_w, np.float32) if delta.add_w is not None
           else np.ones(len(a_src), np.float32))
    return Graph(g.n, src, dst,
                 np.concatenate([w_old[keep], a_w]).astype(np.float32))


def _graph_of(pg: PartitionedGraph) -> Graph:
    """The original-id-space edge list stored in ``pg`` (csr: the exact
    original within-worker order; padded: owner-grouped order)."""
    h = pg.host
    if pg.layout == "csr":
        s_new = np.asarray(h["all_src"], np.int64)
        d_new = np.asarray(h["all_dst"], np.int64)
        w = np.asarray(h["all_w"], np.float32)
    else:
        m = h["all_mask"]
        row = np.nonzero(m)[0]
        s_new = row * pg.n_loc + h["all_src"][m].astype(np.int64)
        d_new = h["all_dst"][m].astype(np.int64)
        w = h["all_w"][m].astype(np.float32)
    return Graph(pg.n, pg.inv_perm[s_new], pg.inv_perm[d_new], w)


def _fold_rebuild(pg: PartitionedGraph, delta: EdgeDelta
                  ) -> PartitionedGraph:
    """The fold of the padded layout and of ``balance="split"`` (whose
    physical shard bounds are a global function of the loads): the mutated
    edge list re-partitioned under the PINNED perm."""
    g2 = apply_delta(_graph_of(pg), delta)
    return partition(g2, pg.M, tau=pg.tau, layout=pg.layout,
                     balance=pg.balance, split_factor=pg.split_factor,
                     hosts=pg.hosts, perm=pg.perm, device=pg.device)


def fold_delta(pg: PartitionedGraph, delta: EdgeDelta) -> PartitionedGraph:
    """Fold a streaming edge delta into the flat csr layout WITHOUT
    re-running ``partition()`` (``repro.graph.structs.fold_delta``, array
    for array): the relabeling, ``n_loc``, ``tau`` and ``vmask`` stay;
    removals are mask-compacted in place and adds appended to each owner's
    segment (where a fresh stable owner sort puts them); Ch_msg is
    recompacted by the new mirrored mask; the mirror csr merges its kept,
    already sorted edges with the sorted pool of incoming ones; the
    Theorem-1 counts are recomputed only for touched sources; and
    ``pair_counts`` stays a monotone UPPER bound (added pairs count,
    removals never decrement; a fresh ``partition()`` re-tightens it).
    The padded layout and ``balance="split"`` take ``_fold_rebuild``.
    """
    if pg.layout != "csr" or pg.balance == "split":
        return _fold_rebuild(pg, delta)
    h = pg.host
    M, n_loc = pg.M, pg.n_loc
    n_ids = M * n_loc
    perm = pg.perm
    tau_eff = pg.tau

    a_src = perm[np.asarray(delta.add_src, np.int64)]
    a_dst = perm[np.asarray(delta.add_dst, np.int64)]
    a_w = (np.asarray(delta.add_w, np.float32)
           if delta.add_w is not None
           else np.ones(len(a_src), np.float32))
    rkey = None
    if len(delta.rem_src):
        rkey = np.unique(perm[np.asarray(delta.rem_src, np.int64)]
                         * n_ids
                         + perm[np.asarray(delta.rem_dst, np.int64)])
        # endpoint tables + hashed-key bitmap prefilter: the exact
        # (sorted-rkey) probe only runs on edges sharing BOTH endpoints
        # with some removal
        t_src = np.zeros(n_ids, bool)
        t_dst = np.zeros(n_ids, bool)
        t_src[(rkey // n_ids)] = True
        t_dst[(rkey % n_ids)] = True
        _hb = np.uint64(64 - 22)            # 4M-entry bitmap
        h_mul = np.uint64(0x9E3779B97F4A7C15)
        h_bit = np.zeros(1 << 22, bool)
        h_bit[((rkey.astype(np.uint64) * h_mul)
               >> _hb).astype(np.int64)] = True

    def _removed(s, d):
        """Indices into (s, d) of edges matching a removal key."""
        if rkey is None or not len(s):
            return np.zeros(0, np.int64)
        c1 = np.flatnonzero(t_src[s])
        ci = c1[t_dst[d[c1]]]
        ck = s[ci].astype(np.int64) * n_ids + d[ci]
        hh = h_bit[((ck.astype(np.uint64) * h_mul)
                    >> _hb).astype(np.int64)]
        ci, ck = ci[hh], ck[hh]
        p = np.searchsorted(rkey, ck)
        p[p == len(rkey)] = 0           # ck > rkey[-1] there: no match
        return ci[rkey[p] == ck]

    all_src, all_dst, all_w = h["all_src"], h["all_dst"], h["all_w"]
    all_off = np.asarray(pg.all_off, np.int64)
    rem_idx = _removed(all_src, all_dst)
    keep = np.ones(len(all_src), bool)
    keep[rem_idx] = False

    deg_old = np.asarray(h["deg"], np.int64).reshape(-1)
    deg_new = (deg_old
               - np.bincount(all_src[rem_idx], minlength=n_ids)
               + np.bincount(a_src, minlength=n_ids))

    # ---- merged full adjacency: kept edges compact in place, adds
    #      counting-sorted by owner and appended per owner segment ------
    rem_owner = np.searchsorted(all_off, rem_idx, side="right") - 1
    a_owner = a_src // n_loc
    ao = np.argsort(a_owner, kind="stable")
    a_src, a_dst, a_w, a_owner = a_src[ao], a_dst[ao], a_w[ao], a_owner[ao]
    kept_cnt = np.diff(all_off) - np.bincount(rem_owner, minlength=M)
    add_cnt = np.bincount(a_owner, minlength=M)
    ad_off = np.concatenate([[0], np.cumsum(add_cnt)]).astype(np.int64)
    new_off = np.concatenate(
        [[0], np.cumsum(kept_cnt + add_cnt)]).astype(np.int64)
    e_new = int(new_off[-1])
    a_src32 = a_src.astype(np.int32)
    a_dst32 = a_dst.astype(np.int32)
    no_rem = not len(rem_idx)

    def _merge(vals, add, dtype):
        # [kept_0, add_0, kept_1, add_1, ...]: exactly where a fresh
        # stable owner-sort of [kept..., adds...] lands them
        out = np.empty(e_new, dtype)
        for w_ in range(M):
            o, kk = new_off[w_], kept_cnt[w_]
            sl = slice(all_off[w_], all_off[w_ + 1])
            out[o:o + kk] = vals[sl] if no_rem else vals[sl][keep[sl]]
            out[o + kk:new_off[w_ + 1]] = add[ad_off[w_]:ad_off[w_ + 1]]
        return out

    na_src = _merge(all_src, a_src32, np.int32)
    na_dst = _merge(all_dst, a_dst32, np.int32)
    na_w = _merge(all_w, a_w, np.float32)

    # ---- pair_counts: monotone upper bound on the caps -----------------
    pair_counts = pg.pair_counts.copy()
    if len(a_src):
        akey = np.unique(a_owner * np.int64(n_ids) + a_dst)
        np.add.at(pair_counts,
                  ((akey // n_ids).astype(np.int64),
                   ((akey % n_ids) // n_loc).astype(np.int64)), 1)

    common = dict(
        n=pg.n, M=M, n_loc=n_loc, tau=tau_eff, perm=perm,
        inv_perm=pg.inv_perm, all_src=na_src, all_dst=na_dst,
        all_mask=np.ones(e_new, bool), all_w=na_w,
        deg=deg_new.astype(np.int32).reshape(M, n_loc), vmask=h["vmask"],
        layout="csr", all_off=new_off, balance=pg.balance,
        split_factor=pg.split_factor, M_phys=M, phys_log=None,
        phys_eg_off=None, phys_all_off=None, phys_mir_off=None, eg_pw=None,
        all_pw=None, mir_pw=None, pair_counts=pair_counts, hosts=pg.hosts)

    if int(deg_old.max()) < tau_eff and int(deg_new.max()) < tau_eff:
        # no vertex is mirrored before or after the fold: Ch_msg IS the
        # full adjacency (one set of tensors, as the reference aliases
        # them) and every mirror field is the empty sentinel pg carries
        out = from_numpy(dict(
            common, eg_src=na_src, eg_dst=na_dst, eg_mask=common["all_mask"],
            eg_w=na_w, eg_off=new_off, mir_eoff=pg.mir_eoff,
            **{k: h[k] for k in ("mir_ids", "mir_slot_of", "mir_nworkers",
                                 "mir_esrc", "mir_edst", "mir_emask",
                                 "mir_ew")}), device=pg.device)
        for k in ("src", "dst", "mask", "w"):
            setattr(out, f"eg_{k}", getattr(out, f"all_{k}"))
            out.host[f"eg_{k}"] = out.host[f"all_{k}"]
        return out

    mirrored_old = deg_old >= tau_eff
    mirrored_new = deg_new >= tau_eff
    flip_up = mirrored_new & ~mirrored_old

    # ---- Ch_msg: recompact from the merged adjacency -------------------
    lo_e = ~mirrored_new[na_src]
    eg_off_n = np.concatenate(
        [[0], np.cumsum(np.bincount((na_src // n_loc)[lo_e],
                                    minlength=M))]).astype(np.int64)

    # ---- mirror csr: merge kept (already sorted) with the pool ---------
    mir_ids_old = np.asarray(h["mir_ids"], np.int64)
    m_esrc_old = np.asarray(h["mir_esrc"], np.int64)
    m_gsrc_old = (mir_ids_old[m_esrc_old] if len(m_esrc_old)
                  else np.zeros(0, np.int64))
    m_gdst_old = np.asarray(h["mir_edst"], np.int64)
    m_w_old = np.asarray(h["mir_ew"], np.float32)
    rem_mir = np.zeros(len(m_gsrc_old), bool)
    rem_mir[_removed(m_gsrc_old, m_gdst_old)] = True
    flip_dn_src = mirrored_old & ~mirrored_new
    keep_mir = ~rem_mir & ~flip_dn_src[m_gsrc_old]

    eg_src_old = np.asarray(h["eg_src"], np.int64)
    eg_dst_old = np.asarray(h["eg_dst"], np.int64)
    eg_w_old = np.asarray(h["eg_w"], np.float32)
    # removal membership only matters on the few flipped-up sources
    fu_idx = np.flatnonzero(flip_up[eg_src_old])
    fu_keep = np.ones(len(fu_idx), bool)
    fu_keep[_removed(eg_src_old[fu_idx], eg_dst_old[fu_idx])] = False
    up_idx = fu_idx[fu_keep]
    a_hi = mirrored_new[a_src]
    p_gsrc = np.concatenate([eg_src_old[up_idx], a_src[a_hi]])
    p_gdst = np.concatenate([eg_dst_old[up_idx], a_dst[a_hi]])
    p_w = np.concatenate([eg_w_old[up_idx], a_w[a_hi]]).astype(np.float32)
    # pool sorted by the mirror key (dst worker, src, dst); lexsort is
    # stable so old-before-add tie order (= fresh partition order) holds
    porder = np.lexsort((p_gdst, p_gsrc, p_gdst // n_loc))
    p_gsrc, p_gdst, p_w = p_gsrc[porder], p_gdst[porder], p_w[porder]

    def _mkey(s, d):
        # composite (dst_worker, src, dst) key; fits int64 while
        # M * n_ids^2 < 2^63
        return (d // n_loc) * (n_ids * n_ids) + s * n_ids + d

    kk = _mkey(m_gsrc_old[keep_mir], m_gdst_old[keep_mir])
    pk = _mkey(p_gsrc, p_gdst)
    n_k, n_p = len(kk), len(pk)
    pos_kept = (np.arange(n_k, dtype=np.int64)
                + np.searchsorted(pk, kk, side="left"))
    pos_pool = (np.arange(n_p, dtype=np.int64)
                + np.searchsorted(kk, pk, side="right"))
    m_gsrc = np.empty(n_k + n_p, np.int64)
    m_gdst = np.empty(n_k + n_p, np.int64)
    m_w = np.empty(n_k + n_p, np.float32)
    m_gsrc[pos_kept], m_gsrc[pos_pool] = m_gsrc_old[keep_mir], p_gsrc
    m_gdst[pos_kept], m_gdst[pos_pool] = m_gdst_old[keep_mir], p_gdst
    m_w[pos_kept], m_w[pos_pool] = m_w_old[keep_mir], p_w
    m_downer = m_gdst // n_loc
    hb_n = np.searchsorted(m_downer, np.arange(M + 1)).astype(np.int64)

    mir_vertex_ids = np.flatnonzero(mirrored_new)
    n_mir = max(len(mir_vertex_ids), 1)
    mir_idx = np.full(n_ids, -1, np.int64)
    mir_idx[mir_vertex_ids] = np.arange(len(mir_vertex_ids))
    mir_ids_arr = np.full(n_mir, n_ids, np.int32)
    mir_ids_arr[:len(mir_vertex_ids)] = mir_vertex_ids

    # ---- Theorem-1 mirror counts: copy untouched, recount touched ------
    touched = np.zeros(n_ids, bool)
    touched[m_gsrc_old[rem_mir]] = True
    touched[p_gsrc] = True
    nworkers = np.zeros(n_mir, np.int64)
    keep_ids = np.flatnonzero(mirrored_old & mirrored_new & ~touched)
    if len(keep_ids):
        old_slot = np.asarray(h["mir_slot_of"], np.int64).reshape(-1)
        nworkers[mir_idx[keep_ids]] = np.asarray(
            h["mir_nworkers"], np.int64)[old_slot[keep_ids]]
    am = touched[m_gsrc]
    if am.any():
        pair = np.unique(m_gsrc[am] * np.int64(M) + m_downer[am])
        cnt = np.bincount((pair // M).astype(np.int64), minlength=n_ids)
        aff = np.flatnonzero(touched & mirrored_new)
        nworkers[mir_idx[aff]] = cnt[aff]

    # the reference's device arrays are 32-bit, so the counts cross as
    # int32, as in partition()
    return from_numpy(dict(
        common,
        eg_src=na_src[lo_e], eg_dst=na_dst[lo_e],
        eg_mask=np.ones(int(lo_e.sum()), bool), eg_w=na_w[lo_e],
        eg_off=eg_off_n, mir_eoff=hb_n,
        mir_ids=mir_ids_arr,
        mir_slot_of=mir_idx.astype(np.int32).reshape(M, n_loc),
        mir_nworkers=nworkers.astype(np.int32),
        mir_esrc=mir_idx[m_gsrc].astype(np.int32),
        mir_edst=m_gdst.astype(np.int32),
        mir_emask=np.ones(n_k + n_p, bool), mir_ew=m_w), device=pg.device)
