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

Streaming mutations (``EdgeDelta``/``apply_delta``/``fold_delta``) belong
to the graph-service slice of the port and are not here yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

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

    def edge_src_values(self, state: torch.Tensor, src: torch.Tensor
                        ) -> torch.Tensor:
        """Read per-vertex ``state`` at each edge's (locally stored) source
        endpoint: ``src`` is (M, E_loc) local slots in the padded layout,
        flat (E,) global slot ids in csr."""
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
    """
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
    mir_vertex_ids = np.flatnonzero(mirrored)          # sorted global ids
    n_mir = max(len(mir_vertex_ids), 1)
    mir_slot_of = np.full((M, n_loc), -1, np.int32)
    mir_slot_of.reshape(-1)[mir_vertex_ids] = np.arange(len(mir_vertex_ids))

    hi = mirrored[src]
    hsrc, hdst, hw = src[hi], dst[hi], w[hi]
    dst_owner = hdst // n_loc
    es_all = np.zeros(0, np.int32)
    edg_all = np.zeros(0, np.int64)                    # global dst ids
    ew_all = np.zeros(0, np.float32)
    hb = np.zeros(M + 1, np.int64)
    nworkers = np.zeros(n_mir, np.int64)
    if len(hsrc):
        # sort once by (dst worker, src, dst), then slice per hosting worker
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
