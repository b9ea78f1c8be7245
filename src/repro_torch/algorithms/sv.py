"""Shiloach-Vishkin connected components (paper §3.4): the request-respond
showcase.  Every vertex u reads D[D[u]] from the owner of D[u], and towards
the end ALL vertices of a component request the same root (the Fig. 2
bottleneck).  Min-hooking variant (hook larger roots onto smaller labels),
which converges to the minimum id of each component in O(log n) rounds.

Message accounting: every pointer read is a request-respond exchange
(msgs_rr vs msgs_basic = the with/without-Ch_req comparison of Fig. 13);
hooking writes go through the combined scatter channel.

Labels are int32 end to end, with the int32 identity (iinfo.max): ids at
or above 2^24 are not representable in float32, so a float round trip
would merge distinct components on graphs of that size.
"""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult
from repro_torch.core import bsp
from repro_torch.core import exec as exec_mod
from repro_torch.core.channels import broadcast, gather, scatter_state
from repro_torch.core.plan import identity_of
from repro_torch.graph.structs import PartitionedGraph


def _acc(stats: dict, s: dict) -> dict:
    """Accumulate a channel stats dict into uniform rr/basic counters: a
    combined channel's ``msgs_combined``/``per_worker_combined`` count as
    its request-respond messages."""
    parts = {"msgs_rr": s.get("msgs_rr", s.get("msgs_combined")),
             "msgs_basic": s["msgs_basic"],
             "per_worker_rr": s.get("per_worker_rr",
                                    s.get("per_worker_combined")),
             "per_worker_basic": s["per_worker_basic"]}
    for k, v in parts.items():
        stats[k] = stats[k] + v if k in stats else v
    return stats


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        max_supersteps: int = 64, device=None) -> RunResult:
    """Shiloach-Vishkin under an EngineConfig.  ``state`` is the
    (M, n_loc) int32 label array (min id of each component).  Pointer
    reads are request-respond exchanges, so ``use_mirroring`` does not
    apply."""
    cfg = config or EngineConfig()
    imax = identity_of("min", torch.int32)
    backend = cfg.backend

    def make_step(g):
        vmask = g.vmask

        def step(D, i):
            stats: dict = {}

            # D[D[u]]: THE skewed pointer read (request-respond)
            DD, s = gather(g, D, D, vmask)
            stats = _acc(stats, s)
            parent_is_root = DD == D

            # cand[u] = min over neighbours v of D[v] (push D, min
            # combiner, in the id dtype)
            cand_i, s = broadcast(g, D, vmask, op="min",
                                  use_mirroring=False, backend=backend)
            stats = _acc(stats, s)
            has_nbr = cand_i != imax
            cand = torch.where(has_nbr, cand_i, 2 ** 30)

            # (1) tree hooking: roots get hooked onto smaller
            # neighbour-parents
            hook_mask = vmask & parent_is_root & has_nbr & (cand < D)
            D1, s = scatter_state(g, D, D, cand, hook_mask, "min",
                                  backend=backend)
            stats = _acc(stats, s)

            # star detection on the hooked forest
            DD1, s = gather(g, D1, D1, vmask)
            stats = _acc(stats, s)
            star = (DD1 == D1).to(torch.int32)
            deep = vmask & (DD1 != D1)
            star, s = scatter_state(g, star, DD1, torch.zeros_like(star),
                                    deep, "min", backend=backend)
            stats = _acc(stats, s)
            star_of_parent, s = gather(g, star, D1, vmask)
            stats = _acc(stats, s)
            in_star = vmask & (star_of_parent > 0)

            # (2) star hooking
            hook2 = in_star & has_nbr & (cand < D1)
            D2, s = scatter_state(g, D1, D1, cand, hook2, "min",
                                  backend=backend)
            stats = _acc(stats, s)

            # (3) shortcutting: D[u] = D[D[u]]
            DD2, s = gather(g, D2, D2, vmask)
            stats = _acc(stats, s)
            D3 = torch.where(vmask, torch.minimum(D2, DD2), D)

            halted = (g.gall(D3 == D) & ~g.gany(hook_mask)
                      & ~g.gany(hook2))
            return D3, halted, stats
        return step

    def init(g):
        return g.local_ids().to(torch.int32)

    if cfg.devices is None:
        D, stats, n, _ = bsp.run(make_step(pg), init(pg), max_supersteps)
        return RunResult(state=D, stats=stats, n_supersteps=n)
    D, stats, n, _, info = exec_mod.run_sharded(
        pg, make_step, init, max_supersteps, devices=cfg.devices,
        device=device,
        plan_kinds=exec_mod.broadcast_plan_kinds(backend,
                                                 use_mirroring=False),
        pipeline=cfg.pipeline)
    return RunResult(state=D, stats=stats, n_supersteps=n, sharded=info)
