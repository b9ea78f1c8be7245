"""Persistent graph service: a resident sharded graph, streaming
mutations, and batched concurrent point queries (the counterpart of
``repro.core.service``).

Everything else in the port is batch: partition once, run one algorithm,
exit.  This module keeps the partitioned graph's shard tables LIVE on the
card and serves traffic from them:

* **Resident executors.**  The shard tables live in one ShardedGraph
  padded to a frozen :class:`~repro_torch.core.exec.ShardProfile`, and
  every query program (one superstep function a batch bucket, and the
  Hash-Min program of the ego lookups) is built ONCE against it.  A fold
  writes the new tables into the same tensors (``exec.reshard``: same
  shapes, same storage), so the built programs keep running.  ``traces``
  counts the programs built, what the reference counts as traces: it
  stays flat across batches and folds, and grows only when the graph
  outgrows its profile and a new one is frozen (``ProfileOverflow``).

* **Streaming mutations with an epoch barrier.**  ``mutate()`` enqueues
  an :class:`~repro_torch.graph.structs.EdgeDelta`; the next ``pump()``
  folds every pending delta into the csr partition (``fold_delta``: no
  re-partition, perm pinned), bumps the epoch and reshards in place.
  Queries are served only between folds, so every answer reads exactly
  one epoch's snapshot.

* **Batching, coalescing and an epoch-keyed result cache.**  Duplicate
  (kind, source) pairs in a batch share one executor lane; answers are
  cached per (epoch, kind, source).

* **One superstep for SSSP and PPR.**  Per-query source columns ride the
  trailing feature axis as ``(lanes, Q)`` blocks, so a 64-query batch is
  one BSP run; batches are padded to fixed buckets (default 4/16/64)
  with dummy lanes.  Ego lookups read per-epoch Hash-Min labels computed
  once an epoch.

The service runs on the sharded executor (``core/exec.py``): one process
a device in the caller's default ``torch.distributed`` group (at world
size 1 too), backend ``"dense"``.  With D > 1 ranks every rank holds a
``GraphService`` and runs the same client program; at each ``pump()``
rank 0's admitted queue and pending deltas are broadcast to all ranks, so
every rank folds and serves the same batch and returns the same results.
At world size 1 nothing runs beyond the executor's own collectives.

The client protocol is the ``Query`` / ``QueryResult`` pair;
:class:`GraphClient` speaks it over a direct method call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import Engine, EngineConfig
from repro_torch.core import exec as exec_mod
from repro_torch.core.channels import broadcast
from repro_torch.core.plan import identity_of
from repro_torch.graph import structs

KINDS = ("sssp", "ppr", "ego")


@dataclasses.dataclass(frozen=True)
class Query:
    """A point query against the resident graph.  ``source`` is an
    ORIGINAL vertex id; ``kind`` one of ``sssp`` (distances from source),
    ``ppr`` (personalized PageRank mass seeded at source) or ``ego`` (the
    source's component root + size)."""
    kind: str
    source: int


@dataclasses.dataclass
class QueryResult:
    """``value``: (n,) float32 per-original-vertex distances (sssp) or
    ppr mass, or a ``(root, size)`` pair (ego).  ``epoch`` names the graph
    snapshot the answer was computed on; ``cached`` marks an epoch-keyed
    cache hit (no executor lanes spent)."""
    query: Query
    epoch: int
    value: Any
    cached: bool = False


class GraphService:
    """Resident graph + admission queue + bucketed batch executors.

    Single-writer, round-based: ``pump()`` alternates [fold pending
    mutations -> bump epoch] with [serve one admitted batch], which IS the
    mutation epoch barrier: a batch never straddles a fold.  ``device``
    is this rank's device (the GPU by default; ``"cpu"`` asks for the
    CPU)."""

    def __init__(self, graph: structs.Graph, M: int = 32,
                 tau: Optional[int] = None,
                 config: Optional[EngineConfig] = None,
                 buckets: Sequence[int] = (4, 16, 64),
                 ppr_alpha: float = 0.15, ppr_iters: int = 20,
                 max_supersteps: int = 512,
                 profile_slack: float = 1.5, seed: int = 0,
                 rebalance_threshold: Optional[float] = None,
                 device: structs.DeviceLike = "cuda"):
        if config is None:
            config = EngineConfig(layout="csr", balance="edges", devices=1)
        if config.layout != "csr" or config.balance == "split":
            raise ValueError("the resident service needs layout='csr' "
                             "and a non-split balance mode ('hash', "
                             "'edges', 'edges+refine', 'vertex-cut'): the "
                             "ShardProfile restrictions")
        if config.backend != "dense":
            raise ValueError("the resident service runs backend='dense' "
                             "(plan tables are content-shaped and cannot "
                             "be refilled in place after a fold)")
        self.devices = config.devices if config.devices is not None else 1
        self.engine = Engine(dataclasses.replace(config,
                                                 devices=self.devices),
                             device=device)
        self.device = self.engine.device
        self.world = dist.get_world_size()
        self.g = graph
        self.M, self.tau, self.seed = int(M), tau, int(seed)
        self.rebalance_threshold = rebalance_threshold
        self.repartitions = 0
        self.pg = self.engine.partition(graph, M, tau=tau, seed=seed)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.ppr_alpha = float(ppr_alpha)
        self.ppr_iters = int(ppr_iters)
        self.max_supersteps = int(max_supersteps)
        self.profile_slack = float(profile_slack)
        self._freeze()
        self.epoch = 0
        self.traces = 0          # resident programs built (see the docs)
        self.last_batch: Dict[str, Any] = {}
        self.last_pump: Dict[str, Any] = {}
        self._execs: Dict[int, Any] = {}     # bucket -> superstep function
        self._cc = None                      # resident Hash-Min superstep
        self._labels: Optional[Tuple] = None  # (epoch, root, size) arrays
        self._queue: List[Tuple[int, Query]] = []
        self._results: Dict[int, QueryResult] = {}
        self._cache: Dict[Tuple, Any] = {}
        self._pending: List[structs.EdgeDelta] = []
        self._next_ticket = 0
        # every query needs a real relabeled slot for its dummy lanes
        self._dummy_src = int(self.pg.perm[0])

    # -- client-facing surface -------------------------------------------

    def submit(self, queries: Sequence[Query]) -> List[int]:
        """Enqueue queries; returns their tickets (serve with pump())."""
        tickets = []
        for q in queries:
            if q.kind not in KINDS:
                raise ValueError(f"unknown query kind {q.kind!r}")
            if not (0 <= q.source < self.pg.n):
                raise ValueError(f"source {q.source} outside the vertex "
                                 f"universe [0, {self.pg.n})")
            t = self._next_ticket
            self._next_ticket += 1
            self._queue.append((t, q))
            tickets.append(t)
        return tickets

    def mutate(self, delta: structs.EdgeDelta) -> None:
        """Enqueue a streaming edge delta; folded at the next pump()
        BEFORE any queued query is served (the epoch barrier)."""
        self._pending.append(delta)

    def take_result(self, ticket: int) -> QueryResult:
        return self._results.pop(ticket)

    def pump(self) -> int:
        """One service round: fold pending mutations, then serve every
        admitted query (in bucket-bounded slices).  Returns the number of
        results produced."""
        self._sync()
        self._fold_pending()
        served = 0
        self.last_pump = {"slices": 0, "lanes_sssp": 0, "lanes_ppr": 0,
                          "n_supersteps": 0, "epoch": self.epoch}
        while self._queue:
            maxb = self.buckets[-1]
            batch: List[Tuple[int, Query]] = []
            lanes = {"sssp": set(), "ppr": set()}
            while self._queue:
                t, q = self._queue[0]
                if q.kind in lanes:
                    lanes[q.kind].add(q.source)
                    if max(len(lanes["sssp"]), len(lanes["ppr"])) > maxb:
                        break
                batch.append(self._queue.pop(0))
            self._serve_batch(batch)
            served += len(batch)
        self._maybe_repartition()
        return served

    def warmup(self) -> None:
        """Build every bucket's superstep function and the component
        program, and run each once with dummy lanes."""
        for b in self.buckets:
            self._run_exec(b, [self._dummy_src], [self._dummy_src])
        self._labels_now()

    def _sync(self) -> None:
        """D > 1: every rank takes rank 0's queue, pending deltas and
        ticket counter, so all ranks fold and serve the same batch."""
        if self.world == 1:
            return
        box = [(self._queue, self._pending, self._next_ticket)]
        dist.broadcast_object_list(box, src=0)
        self._queue, self._pending, self._next_ticket = box[0]

    # -- the resident tables ---------------------------------------------

    def _freeze(self) -> None:
        """Freeze a profile around the current partition and build the
        resident ShardedGraph under it."""
        self.profile = exec_mod.shard_profile(self.pg, self.devices,
                                              slack=self.profile_slack)
        self.sg = exec_mod.shard(self.pg, self.devices, (), self.device,
                                 profile=self.profile)

    def _reshard(self) -> None:
        """Refill the resident tables from ``self.pg`` in place; when the
        graph outgrew the profile, freeze a bigger one and drop the
        resident programs (they are built again when next needed)."""
        try:
            exec_mod.reshard(self.sg, self.pg, self.profile)
        except exec_mod.ProfileOverflow:
            self._freeze()
            self._execs.clear()
            self._cc = None

    # -- mutation folding (the epoch barrier) ----------------------------

    def _fold_pending(self) -> None:
        if not self._pending:
            return
        for d in self._pending:
            self.pg = structs.fold_delta(self.pg, d)
            self.g = structs.apply_delta(self.g, d)
        self._pending = []
        self.epoch += 1
        self._labels = None
        # stale cache keys can never hit again; drop them to stay small
        self._cache = {k: v for k, v in self._cache.items()
                       if k[0] == self.epoch}
        self._reshard()

    # -- telemetry-driven elastic repartition ----------------------------

    def repartition(self) -> None:
        """Re-run the configured partitioner on the CURRENT graph and
        reshard under the frozen profile: a fresh assignment (folds only
        ever grow the monotone ``pair_counts`` caps; this re-tightens
        them) at reshard cost.  The resident programs take the tables
        (vmask and deg included) from the ShardedGraph, so they survive.
        The epoch does NOT bump: the graph is unchanged, so cached
        answers stay valid."""
        self.pg = self.engine.partition(self.g, self.M, tau=self.tau,
                                        seed=self.seed)
        self._reshard()
        self._labels = None
        self._dummy_src = int(self.pg.perm[0])
        self.repartitions += 1

    def _maybe_repartition(self) -> None:
        """The pump()-level elastic trigger: when the measured per-worker
        message load of the last served batch drifts past
        ``rebalance_threshold`` (max/mean), the next partition is computed
        fresh."""
        if self.rebalance_threshold is None or not self.last_batch:
            return
        pw = np.asarray(self.last_batch["stats"].get(
            "per_worker_total", ()), np.float64)
        if pw.size == 0 or pw.mean() <= 0:
            return
        if float(pw.max() / pw.mean()) > float(self.rebalance_threshold):
            self.repartition()

    # -- the unified batched SSSP + PPR executor -------------------------

    def _bucket_for(self, k: int) -> int:
        for b in self.buckets:
            if k <= b:
                return b
        return self.buckets[-1]

    def _query_step(self, g):
        cfg = self.engine.config
        alpha, iters = self.ppr_alpha, self.ppr_iters

        def step(state, i):
            dist_, dact, pr, restart = state
            # landmark SSSP: Q distance columns ride the feature axis
            inbox_d, s1 = broadcast(g, dist_, dact, op="min",
                                    relay="add_w",
                                    use_mirroring=cfg.use_mirroring,
                                    backend=cfg.backend)
            upd = g.vmask[..., None] & (inbox_d < dist_)
            dist_ = torch.where(upd, inbox_d, dist_)
            dact = upd.any(dim=-1)
            # personalized PageRank: power iteration on the same
            # superstep, frozen after exactly ``iters`` iterations
            deg = torch.clamp(g.deg, min=1)[..., None]
            contrib = torch.where(g.vmask[..., None], pr / deg, 0.0)
            pact = g.vmask & (g.deg > 0)
            inbox_p, s2 = broadcast(g, contrib, pact, op="sum",
                                    use_mirroring=cfg.use_mirroring,
                                    backend=cfg.backend)
            if i < iters:
                pr = torch.where(g.vmask[..., None],
                                 alpha * restart + (1 - alpha) * inbox_p,
                                 0.0)
            stats = {k: s1[k] + s2[k] for k in s1}
            halted = (~g.gany(upd)) & (i + 1 >= iters)
            return (dist_, dact, pr, restart), halted, stats
        return step

    def _query_state(self, s_rel: np.ndarray, p_rel: np.ndarray):
        """This rank's initial state for relabeled source slots (padded to
        the bucket width): the rows of the global one-hot columns."""
        sg = self.sg
        lo, rows = sg.w0 * sg.n_loc, sg.m_loc * sg.n_loc

        def columns(rel, fill, hot):
            rel = torch.as_tensor(rel, dtype=torch.int64, device=sg.device)
            x = torch.full((rows, len(rel)), fill, dtype=torch.float32,
                           device=sg.device)
            mine = (rel >= lo) & (rel < lo + rows)
            cols = torch.arange(len(rel), device=sg.device)
            x[rel[mine] - lo, cols[mine]] = hot
            return x.view(sg.m_loc, sg.n_loc, len(rel)), rel[mine] - lo

        dist0, s_loc = columns(s_rel, float("inf"), 0.0)
        dact0 = torch.zeros(rows, dtype=torch.bool, device=sg.device)
        dact0[s_loc] = True
        restart, _ = columns(p_rel, 0.0, 1.0)
        return (dist0, dact0.view(sg.m_loc, sg.n_loc) & sg.vmask, restart,
                restart)

    def _run_exec(self, b: int, s_rel: List[int], p_rel: List[int]):
        """Run the bucket-``b`` executor on padded source lists; returns
        (dist (n_pad, b), ppr (n_pad, b), stats, n_supersteps)."""
        pad = lambda xs: np.asarray(   # noqa: E731
            list(xs) + [self._dummy_src] * (b - len(xs)), np.int64)
        state0 = self._query_state(pad(s_rel), pad(p_rel))
        if b not in self._execs:
            self._execs[b] = self._query_step(self.sg)
            self.traces += 1
        st, stats, n, _, _ = exec_mod.run_on(
            self.sg, self._execs[b], state0, self.max_supersteps,
            final=lambda s: (s[0], s[2]))
        dist_ = st[0].cpu().numpy().reshape(self.pg.n_pad, b)
        pr = st[1].cpu().numpy().reshape(self.pg.n_pad, b)
        return dist_, pr, stats, int(n)

    # -- per-epoch component labels (ego lookups) ------------------------

    def _cc_step(self, g):
        cfg = self.engine.config

        def step(state, i):
            minv, active = state
            inbox, stats = broadcast(g, minv, active, op="min",
                                     use_mirroring=cfg.use_mirroring,
                                     backend=cfg.backend)
            upd = g.vmask & (inbox < minv)
            return (torch.where(upd, inbox, minv), upd), ~g.gany(upd), stats
        return step

    def _labels_now(self):
        if self._labels is not None and self._labels[0] == self.epoch:
            return self._labels
        if self._cc is None:
            self._cc = self._cc_step(self.sg)
            self.traces += 1
        sg = self.sg
        imax = identity_of("min", torch.int32)
        ids = sg.local_ids().to(torch.int32)
        state0 = (torch.where(sg.vmask, ids, imax), sg.vmask.clone())
        labels, _, _, _, _ = exec_mod.run_on(
            sg, self._cc, state0, self.max_supersteps,
            final=lambda s: s[0])
        root = structs.canonical_labels(self.pg, labels)  # (n,) min orig id
        _, inv, counts = np.unique(root, return_inverse=True,
                                   return_counts=True)
        self._labels = (self.epoch, root, counts[inv])
        return self._labels

    # -- batch serving ----------------------------------------------------

    def _serve_batch(self, batch: List[Tuple[int, Query]]) -> None:
        pre_cached = {(self.epoch, q.kind, q.source) for _, q in batch
                      if (self.epoch, q.kind, q.source) in self._cache}
        need: Dict[str, List[int]] = {"sssp": [], "ppr": []}
        for _, q in batch:
            key = (self.epoch, q.kind, q.source)
            if key in self._cache or q.kind == "ego":
                continue
            if q.source not in need[q.kind]:
                need[q.kind].append(q.source)
        n_lanes = max(len(need["sssp"]), len(need["ppr"]))
        if n_lanes:
            b = self._bucket_for(n_lanes)
            s_rel = [int(self.pg.perm[v]) for v in need["sssp"]]
            p_rel = [int(self.pg.perm[v]) for v in need["ppr"]]
            dist_, pr, stats, n = self._run_exec(b, s_rel, p_rel)
            # per-query original-id-order vectors
            dists = dist_[self.pg.perm]   # (n, b)
            prs = pr[self.pg.perm]
            for j, v in enumerate(need["sssp"]):
                self._cache[(self.epoch, "sssp", v)] = dists[:, j].copy()
            for j, v in enumerate(need["ppr"]):
                self._cache[(self.epoch, "ppr", v)] = prs[:, j].copy()
            self.last_batch = {"bucket": b, "epoch": self.epoch,
                               "lanes_sssp": len(s_rel),
                               "lanes_ppr": len(p_rel),
                               "n_supersteps": n, "stats": stats}
            lp = self.last_pump
            lp["slices"] += 1
            lp["lanes_sssp"] += len(s_rel)
            lp["lanes_ppr"] += len(p_rel)
            lp["n_supersteps"] += n
        if any(q.kind == "ego" for _, q in batch):
            _, root, size = self._labels_now()
            for _, q in batch:
                if q.kind == "ego":
                    self._cache[(self.epoch, "ego", q.source)] = (
                        int(root[q.source]), int(size[q.source]))
        for t, q in batch:
            key = (self.epoch, q.kind, q.source)
            self._results[t] = QueryResult(
                query=q, epoch=self.epoch, value=self._cache[key],
                cached=key in pre_cached)

    def snapshot_graph(self) -> structs.Graph:
        """The host-side edge list of the CURRENT epoch (the oracles'
        input)."""
        return self.g


class GraphClient:
    """In-process client speaking the Query/QueryResult protocol.  The
    transport is a direct call into the service's admission queue; a
    remote transport would serialize the same dataclasses."""

    def __init__(self, service: GraphService):
        self.service = service

    def request(self, queries: Sequence[Query]) -> List[QueryResult]:
        """Submit a batch and drive the service until every answer is in;
        results come back in submission order."""
        tickets = self.service.submit(queries)
        while any(t not in self.service._results for t in tickets):
            self.service.pump()
        return [self.service.take_result(t) for t in tickets]

    def sssp(self, source: int) -> QueryResult:
        return self.request([Query("sssp", source)])[0]

    def ppr(self, source: int) -> QueryResult:
        return self.request([Query("ppr", source)])[0]

    def ego(self, source: int) -> QueryResult:
        return self.request([Query("ego", source)])[0]
