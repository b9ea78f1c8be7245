"""Hash-Min connected components (paper §3.3): broadcast the smallest id
seen so far with a min combiner.  The Fig. 1 balance workload.

Labels are int32 end to end, with the int32 identity (iinfo.max): ids above
2^24 are not representable in float32, so a float round trip would merge
distinct components on graphs of that size.
"""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult
from repro_torch.core import bsp
from repro_torch.core import exec as exec_mod
from repro_torch.core.channels import broadcast
from repro_torch.core.plan import identity_of
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        max_supersteps: int = 10_000, record_history: bool = False,
        device=None) -> RunResult:
    """Hash-Min under an EngineConfig.  ``state`` is the (M, n_loc) int32
    label array (min relabeled id of each component).  ``devices=None``
    runs on ``pg``'s device; an int or an ``(H, T)`` mesh runs this rank
    of the sharded executor on ``device`` (the same labels and stats)."""
    cfg = config or EngineConfig()

    def make_step(g):
        def step(state, i):
            minv, active = state
            inbox, stats = broadcast(g, minv, active, op="min",
                                     use_mirroring=cfg.use_mirroring,
                                     backend=cfg.backend)
            upd = g.vmask & (inbox < minv)
            new = torch.where(upd, inbox, minv)
            return (new, upd), ~g.gany(upd), stats
        return step

    def init(g):
        ids = g.local_ids().to(torch.int32)
        return (torch.where(g.vmask, ids, identity_of("min", torch.int32)),
                g.vmask)

    if cfg.devices is None:
        st, stats, n, hist = bsp.run(make_step(pg), init(pg), max_supersteps,
                                     record_history=record_history)
        return RunResult(state=st[0], stats=stats, n_supersteps=n,
                         history=hist)
    st, stats, n, hist, info = exec_mod.run_sharded(
        pg, make_step, init, max_supersteps, record_history=record_history,
        devices=cfg.devices, device=device, final=lambda s: s[0],
        plan_kinds=exec_mod.broadcast_plan_kinds(cfg.backend,
                                                 cfg.use_mirroring),
        pipeline=cfg.pipeline)
    return RunResult(state=st, stats=stats, n_supersteps=n, history=hist,
                     sharded=info)
