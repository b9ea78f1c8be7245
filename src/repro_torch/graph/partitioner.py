"""The pluggable partitioner layer behind ``structs.partition()``.

A :class:`Partitioner` turns a host graph into a vertex relabeling plus
a declarative :class:`SplitSpec`::

    assign(g, M, hosts) -> (perm, split_spec)

``perm`` is the block relabeling (``owner(v) = perm[v] // n_loc``);
``split_spec`` tells ``partition()`` what to physically split *after*
the edge arrays are built — nothing, hot-worker edge ranges
(``balance="split"``), or the state rows of mega-hub vertices
(``balance="vertex-cut"``, realized as forced mirroring so the existing
master/replica combine and the Theorem-1 lane bound do the heavy
lifting).  ``structs.partition()``/``fold_delta()``, the cost model,
the sharded executor's cap hints and the resident service all consume
partitions through this one seam; a pinned ``perm`` bypasses it (the
fold-parity contract).

Balance modes (``partitioner_for``):

* ``"hash"``         — random permutation (Pregel baseline).
* ``"edges"``        — greedy LPT edge-cost balancing
  (``cost_model.vertex_cost`` + ``greedy_assign``).
* ``"edges+refine"`` — ``"edges"`` followed by a greedy locality
  refinement pass (``cost_model.refine_assignment``): vertices migrate
  toward the worker holding most of their neighbors, strictly
  descending the ``pair_counts`` crossness objective under the same
  slot/load caps, with cross-host lanes priced higher than
  cross-device ones when ``hosts`` is set.
* ``"split"``        — ``"edges"`` plus hot-worker edge-range splitting
  (physical shards; csr only).
* ``"vertex-cut"``   — ``"edges"`` plus mega-hub state-row splitting: a
  vertex whose degree exceeds the split threshold
  (``split_factor * m / M`` — one worker's fair edge share) is force-
  mirrored whatever ``tau``, so its fan-out rows live sharded across
  the destination workers (master keeps the state row, replicas
  combine locally, Theorem-1 bounds the lanes per target per level).

Every mode applies the host-affinity regroup when ``hosts`` is
given, BEFORE refinement — so refinement sees (and prices) the final
host blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.core import cost_model

#: every balance mode ``partition(..., balance=...)`` accepts
BALANCES = ("hash", "edges", "edges+refine", "split", "vertex-cut")


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    """What ``partition()`` should split once the edge arrays exist.

    ``kind``: ``"none"`` | ``"edge_ranges"`` (hot-worker physical
    shards) | ``"vertex_cut"`` (mega-hub forced mirroring).
    ``vc_thresh``: the vertex-cut degree threshold — ``partition()``
    folds it into the effective mirroring threshold
    (``tau_eff = min(tau_eff, vc_thresh)``), which is all the mirror
    machinery needs to split the hub's state rows.
    """
    kind: str = "none"
    split_factor: float = 1.2
    vc_thresh: Optional[int] = None


@runtime_checkable
class Partitioner(Protocol):
    """The pluggable assignment stage: graph -> (perm, SplitSpec)."""
    name: str

    def assign(self, g, M: int,
               hosts: Optional[int] = None
               ) -> Tuple[np.ndarray, SplitSpec]:
        ...


def _block_perm(assign: np.ndarray, M: int, n_loc: int) -> np.ndarray:
    """Worker assignment -> block relabeling: each worker's vertices get
    consecutive new ids in its block (``owner(v) = v // n_loc`` holds;
    blocks may have trailing unused slots)."""
    n = len(assign)
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=M)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
    perm = np.empty(n, np.int64)
    perm[order] = assign[order] * n_loc + pos
    return perm


def host_regroup(g, perm: np.ndarray, M: int, n_loc: int,
                 hosts: int) -> np.ndarray:
    """Relabel worker blocks so heavy-communicating pairs share a host
    block of M/H workers (``cost_model.affinity_groups`` over the
    worker-pair traffic of the tentative assignment).  Slot within the
    block is preserved — only worker *placement* changes."""
    if M % hosts:
        raise ValueError(f"M={M} workers must divide over hosts={hosts}")
    n_ids = M * n_loc
    s0 = perm[g.src] // n_loc
    pkey0 = np.unique(s0 * np.int64(n_ids) + perm[g.dst])
    pc0 = np.zeros((M, M), np.int64)
    np.add.at(pc0, ((pkey0 // n_ids).astype(np.int64),
                    ((pkey0 % n_ids) // n_loc).astype(np.int64)), 1)
    worker_order = cost_model.affinity_groups(
        cost_model.worker_affinity(pc0), hosts)
    rank = np.empty(M, np.int64)
    rank[worker_order] = np.arange(M)
    return rank[perm // n_loc] * n_loc + perm % n_loc


def _maybe_regroup(g, perm, M, n_loc, hosts):
    if hosts is not None and hosts > 1:
        return host_regroup(g, perm, M, n_loc, hosts)
    return perm


@dataclasses.dataclass(frozen=True)
class HashPartitioner:
    """Random relabeling — distributionally Pregel's hash partitioning."""
    seed: int = 0
    name: str = "hash"

    def assign(self, g, M, hosts=None):
        n_loc = -(-g.n // M)
        rng = np.random.RandomState(self.seed)
        perm = rng.permutation(g.n).astype(np.int64)
        return _maybe_regroup(g, perm, M, n_loc, hosts), SplitSpec()


@dataclasses.dataclass(frozen=True)
class EdgeBalancedPartitioner:
    """Greedy LPT edge-cost balancing (``balance="edges"``)."""
    tau: Optional[int] = None
    name: str = "edges"

    def _assign_workers(self, g, M, n_loc, tau_price=None):
        deg = np.bincount(g.src, minlength=g.n)
        cost = cost_model.vertex_cost(
            deg, M, self.tau if tau_price is None else tau_price)
        return cost, cost_model.greedy_assign(cost, M, n_loc)

    def assign(self, g, M, hosts=None):
        n_loc = -(-g.n // M)
        _, wk = self._assign_workers(g, M, n_loc)
        perm = _block_perm(wk, M, n_loc)
        return _maybe_regroup(g, perm, M, n_loc, hosts), SplitSpec()


@dataclasses.dataclass(frozen=True)
class RefinedPartitioner(EdgeBalancedPartitioner):
    """``"edges"`` + the greedy crossness-descent refinement pass
    (``balance="edges+refine"``).  Refinement runs AFTER the host
    regroup so cross-host lanes are priced ``cross_host_weight`` times
    a cross-device lane."""
    rounds: int = 3
    cross_host_weight: float = 4.0
    name: str = "edges+refine"

    def assign(self, g, M, hosts=None):
        n_loc = -(-g.n // M)
        cost, wk = self._assign_workers(g, M, n_loc)
        perm = _maybe_regroup(g, _block_perm(wk, M, n_loc), M, n_loc,
                              hosts)
        weight = cost_model.pair_weight(
            M, hosts=hosts, cross_host_weight=self.cross_host_weight)
        refined, _ = cost_model.refine_assignment(
            g.src, g.dst, perm // n_loc, M, n_loc, cost,
            weight=weight, rounds=self.rounds)
        return _block_perm(refined, M, n_loc), SplitSpec()


@dataclasses.dataclass(frozen=True)
class SplitPartitioner(EdgeBalancedPartitioner):
    """``"edges"`` + hot-worker edge-range splitting into physical
    shards (``balance="split"``; boundaries are placed by
    ``partition()`` once the csr offsets exist)."""
    split_factor: float = 1.2
    name: str = "split"

    def assign(self, g, M, hosts=None):
        perm, _ = super().assign(g, M, hosts)
        return perm, SplitSpec(kind="edge_ranges",
                               split_factor=self.split_factor)


@dataclasses.dataclass(frozen=True)
class VertexCutPartitioner(EdgeBalancedPartitioner):
    """``"edges"`` + mega-hub state-row splitting
    (``balance="vertex-cut"``): any vertex whose degree exceeds one
    worker's fair edge share times ``split_factor`` is force-mirrored.
    Its adjacency rows then live sharded across the destination
    workers (the mirror csr groups them by hosting worker) while the
    master keeps the state row — the existing master/replica mirror
    combine bounds the broadcast at min(M, d) lanes (Theorem 1, per
    level on the hierarchical mesh).  Unlike ``"split"`` this lowers
    the *logical* per-worker load, so it composes with the resident
    service's ShardProfile (no physical shard meta)."""
    split_factor: float = 1.2
    name: str = "vertex-cut"

    def vc_thresh(self, g, M: int) -> int:
        """Smallest degree strictly above the split threshold."""
        return int(self.split_factor * g.m / M) + 1

    def assign(self, g, M, hosts=None):
        n_loc = -(-g.n // M)
        vc_t = self.vc_thresh(g, M)
        tau_price = min(self.tau, vc_t) if self.tau is not None else vc_t
        # price the cut vertices honestly: their per-superstep message
        # bound is the Theorem-1 min(M, d), not d
        _, wk = self._assign_workers(g, M, n_loc, tau_price=tau_price)
        perm = _block_perm(wk, M, n_loc)
        return (_maybe_regroup(g, perm, M, n_loc, hosts),
                SplitSpec(kind="vertex_cut",
                          split_factor=self.split_factor,
                          vc_thresh=vc_t))


def partitioner_for(balance: str, tau: Optional[int] = None,
                    seed: int = 0,
                    split_factor: float = 1.2) -> Partitioner:
    """The registry ``structs.partition()`` resolves ``balance`` through."""
    if balance == "hash":
        return HashPartitioner(seed=seed)
    if balance == "edges":
        return EdgeBalancedPartitioner(tau=tau)
    if balance == "edges+refine":
        return RefinedPartitioner(tau=tau)
    if balance == "split":
        return SplitPartitioner(tau=tau, split_factor=split_factor)
    if balance == "vertex-cut":
        return VertexCutPartitioner(tau=tau, split_factor=split_factor)
    raise ValueError(f"unknown balance {balance!r}; use one of "
                     f"{BALANCES}")
