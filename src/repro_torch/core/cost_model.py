"""The paper's cost model: Theorems 1-3, the mirroring threshold, and the
load-balance model behind ``partition(..., balance=...)``.

Theorem 1: with mirroring, a vertex v delivers a(v) to all neighbors with
           <= min(M, d(v)) messages.
Theorem 2: mirror v iff d(v) >= tau* = M * exp(deg_avg / M)  (the point
           where mirroring beats sender-side combining in expectation).
Theorem 3: request-respond serves l requesters of one target with
           2*min(M, l) messages instead of 2*l.

Load balancing (paper §4 / GraphD): per-worker *edge* load, not vertex
count, governs superstep wall time.  ``vertex_cost`` prices each vertex as
local edge storage plus its per-superstep message bound (Theorem 1 for
mirrored vertices), ``greedy_assign`` packs vertices onto workers LPT-style
under the block-partition capacity, ``choose_split`` decides how many
physical shards a still-hot worker needs, and ``contiguous_bounds``
partitions a run of physical shards over devices minimizing the bottleneck.
``straggler_report`` quantifies the imbalance that remains (Figs. 1/2).

A numpy copy of ``repro.core.cost_model`` (the port imports nothing of the
JAX package), without the MoE expert-mirroring threshold.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, Optional

import numpy as np


def mirror_threshold(M: int, deg_avg: float) -> float:
    """Theorem 2: tau* = M * exp(deg_avg / M)."""
    return M * math.exp(deg_avg / M)


def thm1_bound(M: int, degree: int) -> int:
    return min(M, degree)


def thm3_bound(M: int, n_requesters: int) -> int:
    return 2 * min(M, n_requesters)


def expected_messages_combined(deg: np.ndarray, M: int) -> float:
    """Expected #messages for one all-neighbors broadcast through the
    combined channel under the paper's random-graph model: each vertex's
    message to a neighbor survives combining with prob exp(-deg_avg/M)
    (proof of Thm 2)."""
    deg_avg = float(deg.mean())
    return float(deg.sum() * math.exp(-deg_avg / M))


def expected_messages_mirrored(deg: np.ndarray, M: int, tau: float) -> float:
    """Expected #messages when vertices with d >= tau are mirrored."""
    hi = deg >= tau
    deg_avg = float(deg.mean())
    lo_msgs = float(deg[~hi].sum() * math.exp(-deg_avg / M))
    hi_msgs = float(np.minimum(deg[hi], M).sum())
    return lo_msgs + hi_msgs


def choose_tau(deg: np.ndarray, M: int) -> int:
    """The cost model's automatic threshold (rounded)."""
    return int(round(mirror_threshold(M, float(deg.mean()))))


# ---------------------------------------------------------------------------
# load-balance model: vertex costs, greedy assignment, hot-worker splitting
# ---------------------------------------------------------------------------

def vertex_cost(deg: np.ndarray, M: int,
                tau: Optional[int] = None) -> np.ndarray:
    """Per-vertex balance cost for ``balance="edges"``: local edge storage
    (d(v) adjacency entries) plus the per-superstep message bound — the
    Theorem-1 bound min(M, d(v)) for mirrored vertices (d >= tau), d(v)
    itself for combined-channel vertices."""
    deg = np.asarray(deg, np.int64)
    tau_eff = int(tau) if tau is not None else int(deg.max(initial=0)) + 1
    msg = np.where(deg >= tau_eff, np.minimum(deg, M), deg)
    return deg + msg


def greedy_assign(cost: np.ndarray, M: int, cap: int) -> np.ndarray:
    """LPT vertex->worker assignment under the block-partition capacity:
    vertices in descending cost order each go to the least-loaded worker
    that still has a free local slot (at most ``cap`` vertices per worker).
    Returns the (n,) int64 worker id per vertex."""
    cost = np.asarray(cost, np.int64)
    n = len(cost)
    if M * cap < n:
        raise ValueError(f"capacity {M}x{cap} < {n} vertices")
    order = np.argsort(-cost, kind="stable")
    assign = np.empty(n, np.int64)
    remaining = np.full(M, cap, np.int64)
    heap = [(0, w) for w in range(M)]
    for v in order:
        load, w = heapq.heappop(heap)
        assign[v] = w
        remaining[w] -= 1
        if remaining[w] > 0:
            heapq.heappush(heap, (load + int(cost[v]), w))
    return assign


def choose_split(edge_load: np.ndarray, split_factor: float = 1.2
                 ) -> np.ndarray:
    """Physical shards per worker for ``balance="split"``: a worker whose
    edge load exceeds ``split_factor x`` the mean splits into
    ceil(load / (split_factor * mean)) equal-edge-count shards (each shard
    lands at or below the hot threshold); everyone else stays whole."""
    load = np.asarray(edge_load, np.float64)
    k = np.ones(len(load), np.int64)
    mean = load.mean() if load.size else 0.0
    if mean <= 0:
        return k
    target = split_factor * mean
    hot = load > target
    k[hot] = np.ceil(load[hot] / target).astype(np.int64)
    return k


def pair_weight(M: int, hosts: Optional[int] = None,
                cross_host_weight: float = 4.0) -> np.ndarray:
    """(M, M) per-worker-pair lane price for the crossness objective:
    0 on the diagonal (intra-worker messages never hit a wire), 1 for a
    cross-worker pair, ``cross_host_weight`` for a pair straddling two
    host blocks of M/H workers (the hierarchical mesh's expensive axis —
    refinement should prefer un-crossing a host link over a device
    link)."""
    W = np.ones((M, M), np.float64)
    if hosts is not None and hosts > 1:
        if M % hosts:
            raise ValueError(f"M={M} workers must divide over "
                             f"hosts={hosts}")
        hid = np.arange(M) // (M // hosts)
        W[hid[:, None] != hid[None, :]] = float(cross_host_weight)
    np.fill_diagonal(W, 0.0)
    return W


def crossness(pair_counts: np.ndarray,
              weight: Optional[np.ndarray] = None) -> float:
    """The locality objective ``refine_assignment`` descends: the
    weighted count of distinct cross-worker (source worker, destination
    vertex) pairs — exactly the combined messages a full broadcast
    superstep puts on the wire (``pair_counts`` IS that matrix)."""
    pc = np.asarray(pair_counts, np.float64)
    if weight is None:
        weight = pair_weight(len(pc))
    return float((pc * weight).sum())


def refine_assignment(src: np.ndarray, dst: np.ndarray,
                      assign: np.ndarray, M: int, cap: int,
                      cost: np.ndarray,
                      weight: Optional[np.ndarray] = None,
                      rounds: int = 3) -> tuple:
    """Greedy locality refinement of a vertex->worker assignment:
    move (or swap) vertices toward the worker holding most of their
    neighbors, strictly descending the ``crossness`` objective
    (distinct (source worker, destination vertex) pairs, weighted by
    ``weight``) while never exceeding the ``greedy_assign``
    constraints — at most ``cap`` vertices per worker and never
    raising the max per-worker ``cost`` load above its starting value
    (equal-or-better balance by construction).

    Each round evaluates every vertex's gain against a frozen snapshot
    (vectorized over the deduplicated edge list), then applies the
    candidate moves in descending-gain order with an EXACT incremental
    re-check, so interacting moves can never ascend the objective.  A
    move blocked by a full target worker (the common case: when M
    divides n every slot is taken) is retried as a SWAP with the best
    opposite-direction candidate, committed only if the exact combined
    gain still descends.  Returns ``(assign, n_moves)``.
    """
    n = len(assign)
    owner = np.asarray(assign, np.int64).copy()
    cost = np.asarray(cost, np.int64)
    # distinct directed pairs only (parallel edges don't add crossness);
    # self-loops move with their vertex and never cross
    key = np.unique(np.asarray(src, np.int64) * n
                    + np.asarray(dst, np.int64))
    es = key // n
    ed = key % n
    keep = es != ed
    es, ed = es[keep], ed[keep]
    order_e = np.argsort(es, kind="stable")
    es, ed = es[order_e], ed[order_e]
    indptr = np.searchsorted(es, np.arange(n + 1))

    W = pair_weight(M) if weight is None else np.asarray(weight,
                                                         np.float64)
    # C[u, w] = # distinct in-neighbors of u on worker w: pair (w, u)
    # exists iff C[u, w] > 0
    C = np.zeros((n, M), np.int32)
    np.add.at(C, (ed, owner[es]), 1)
    loads = np.zeros(M, np.int64)
    np.add.at(loads, owner, cost)
    slots = np.bincount(owner, minlength=M)
    load_cap = int(loads.max(initial=0))
    rows = np.arange(n)
    total_moves = 0

    def _exact_gain(v, av, bv):
        # J-delta of moving v: av -> bv under the CURRENT C/owner
        nzw = np.flatnonzero(C[v])
        g = W[nzw, av].sum() - W[nzw, bv].sum()
        nb = ed[indptr[v]:indptr[v + 1]]
        onb = owner[nb]
        g += ((C[nb, av] == 1) * W[av, onb]).sum()
        g -= ((C[nb, bv] == 0) * W[bv, onb]).sum()
        return g

    def _apply(v, av, bv):
        owner[v] = bv
        loads[av] -= cost[v]
        loads[bv] += cost[v]
        slots[av] -= 1
        slots[bv] += 1
        nb = ed[indptr[v]:indptr[v + 1]]
        np.add.at(C, (nb, av), -1)
        np.add.at(C, (nb, bv), 1)

    for _ in range(max(int(rounds), 0)):
        # frozen sweep: J-delta of moving v from a=owner[v] to its
        # dominant in-neighbor worker b, in two exact parts —
        #  1. v as destination: pairs (s, v) reprice from W[s, a] to
        #     W[s, b] over v's distinct in-neighbor workers s;
        #  2. v as source: for each out-neighbor u, pair (a, u) drops
        #     iff v was a's last in-edge of u, pair (b, u) appears iff
        #     b had none
        Z = (C > 0).astype(np.float64) @ W
        a = owner
        cand = np.argmax(C, axis=1).astype(np.int64)
        gain = Z[rows, a] - Z[rows, cand]
        a_e, b_e, o_u = a[es], cand[es], a[ed]
        part2 = ((C[ed, a_e] == 1) * W[a_e, o_u]
                 - (C[ed, b_e] == 0) * W[b_e, o_u])
        np.add.at(gain, es, part2)
        todo = np.flatnonzero((cand != a) & (C[rows, cand] > 0)
                              & (gain > 1e-9))
        todo = todo[np.argsort(-gain[todo], kind="stable")]
        # opposite-direction swap partners, best gain first, keyed by
        # the FROZEN (from, to) direction (staleness re-checked at pop)
        partners: dict = {}
        for v in todo:
            partners.setdefault((int(a[v]), int(cand[v])),
                                []).append(int(v))
        heads = {k: 0 for k in partners}
        moved = np.zeros(n, bool)
        moves = 0
        for v in todo:
            if moved[v]:
                continue
            av, bv = int(owner[v]), int(cand[v])
            if av == bv:
                continue
            # exact re-check under the CURRENT state (earlier moves in
            # this sweep may have changed both terms)
            g = _exact_gain(v, av, bv)
            if g <= 1e-9:
                continue
            if slots[bv] < cap and loads[bv] + cost[v] <= load_cap:
                _apply(v, av, bv)
                moved[v] = True
                moves += 1
                continue
            # target full: pair with the best reverse-direction (bv ->
            # av) candidate u; a swap keeps slot counts and is accepted
            # only if the exact COMBINED gain descends and neither
            # worker's load exceeds its cap
            queue = partners.get((bv, av))
            if queue is None:
                continue
            _apply(v, av, bv)  # tentative (slots may sit at cap + 1)
            done = False
            for _try in range(4):
                i = heads[(bv, av)]
                if i >= len(queue):
                    break
                u = queue[i]
                heads[(bv, av)] = i + 1
                if moved[u] or u == v or int(owner[u]) != bv:
                    continue
                if (loads[bv] - cost[u] > load_cap
                        or loads[av] + cost[u] > load_cap):
                    continue
                gu = _exact_gain(u, bv, av)
                if g + gu > 1e-9:
                    _apply(u, bv, av)
                    moved[v] = moved[u] = True
                    moves += 2
                    done = True
                break
            if not done:
                _apply(v, bv, av)  # revert the tentative half
        total_moves += moves
        if not moves:
            break
    return owner, total_moves


def worker_affinity(pair_counts: np.ndarray) -> np.ndarray:
    """Symmetric (M, M) worker communication affinity from the partition's
    distinct (source worker, destination vertex) pair matrix: traffic in
    either direction counts (the exchange is bidirectional wire either
    way) and self-traffic is zeroed (it never crosses a link).  Mirror
    broadcasts ride the same matrix — ``pair_counts`` is built over the
    full adjacency, so a heavy mirror pair shows up as a heavy entry."""
    pc = np.asarray(pair_counts, np.int64)
    aff = pc + pc.T
    np.fill_diagonal(aff, 0)
    return aff


def affinity_groups(aff: np.ndarray, H: int) -> np.ndarray:
    """Group M workers into H equal host blocks with high intra-block
    affinity — the placement knob of the hierarchical (host, device)
    mesh, which maps worker block ``[h*T, (h+1)*T)`` onto host h, so
    intra-block traffic rides the cheap intra-host level.

    Greedy: each block is seeded with the heaviest-affinity unassigned
    pair, then absorbs the unassigned worker with the largest affinity
    to the block until full.  Falls back to the identity (contiguous)
    grouping when greedy does not strictly beat it, so host-aware
    placement never scores below host-oblivious placement in the
    affinity proxy.  Returns the (M,) worker order, host by host: the
    worker at position i gets new id i."""
    aff = np.asarray(aff, np.float64)
    M = len(aff)
    if H <= 0 or M % H:
        raise ValueError(f"M={M} workers must divide over hosts={H}")
    T = M // H
    left = list(range(M))
    order = []
    for _ in range(H):
        rem = np.asarray(left)
        sub = aff[np.ix_(rem, rem)].copy()
        np.fill_diagonal(sub, -1.0)
        i, j = np.unravel_index(int(sub.argmax()), sub.shape)
        grp = [int(rem[i])] if T == 1 else [int(rem[i]), int(rem[j])]
        while len(grp) < T:
            cand = np.asarray([w for w in left if w not in grp])
            scores = aff[np.ix_(cand, np.asarray(grp))].sum(axis=1)
            grp.append(int(cand[int(scores.argmax())]))
        order += sorted(grp)  # stable ids within a host
        left = [w for w in left if w not in grp]
    greedy = np.asarray(order, np.int64)
    ident = np.arange(M, dtype=np.int64)

    def intra(o):
        return sum(aff[np.ix_(o[h * T:(h + 1) * T],
                              o[h * T:(h + 1) * T])].sum()
                   for h in range(H))

    return greedy if intra(greedy) > intra(ident) else ident


def contiguous_bounds(loads: np.ndarray, D: int) -> np.ndarray:
    """Partition a run of shard ``loads`` into D contiguous non-empty
    groups minimizing the max group load (binary search on the bottleneck
    + greedy feasibility).  Returns (D+1,) shard-index bounds."""
    loads = np.asarray(loads, np.int64)
    P = len(loads)
    if P < D:
        raise ValueError(f"{P} shards < {D} devices")
    prefix = np.concatenate([[0], np.cumsum(loads)])

    def bounds_for(cap):
        b = [0]
        for d in range(D):
            s = b[-1]
            # furthest end within cap that still leaves >=1 shard per
            # remaining group
            e_max = P - (D - d - 1)
            e = int(np.searchsorted(prefix, prefix[s] + cap, side="right")
                    ) - 1
            e = min(max(e, s + 1), e_max)
            b.append(e)
        return np.asarray(b, np.int64) if b[-1] == P else None

    lo = max(int(loads.max(initial=0)), -(-int(prefix[-1]) // D))
    hi = int(prefix[-1]) or 1
    while lo < hi:
        mid = (lo + hi) // 2
        if bounds_for(mid) is None:
            lo = mid + 1
        else:
            hi = mid
    out = bounds_for(lo)
    assert out is not None
    return out


def predicted_balance(cost: np.ndarray, assign: np.ndarray,
                      M: int) -> Dict[str, float]:
    """Balance predictor: the straggler report the cost model *expects*
    from an assignment, before any graph arrays are built."""
    loads = np.bincount(np.asarray(assign), weights=np.asarray(cost,
                                                               np.float64),
                        minlength=M)
    return straggler_report(loads)


def straggler_report(per_worker_msgs: np.ndarray) -> Dict[str, float]:
    """Imbalance metrics for a per-worker load histogram (Figs. 1/2):
    a worker 2x over the mean is a 2x straggler in a synchronous step."""
    m = np.asarray(per_worker_msgs, np.float64)
    mean = m.mean() if m.size else 0.0
    return {
        "max_over_mean": float(m.max() / mean) if mean > 0 else 0.0,
        "cv": float(m.std() / mean) if mean > 0 else 0.0,
        "gini": _gini(m),
    }


def _gini(x: np.ndarray) -> float:
    if x.sum() == 0:
        return 0.0
    xs = np.sort(x)
    n = len(xs)
    cum = np.cumsum(xs)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)
