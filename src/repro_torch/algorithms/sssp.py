"""Single-source shortest paths (paper §5, "Handling Edge Fields"): the
message value depends on the edge, so Ch_mir applies relay(msg) — the edge
weight is added at the *mirror* side, Ch_msg at the sender side."""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult
from repro_torch.core import bsp
from repro_torch.core import exec as exec_mod
from repro_torch.core.channels import broadcast
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        source: int, max_supersteps: int = 10_000, device=None) -> RunResult:
    """SSSP under an EngineConfig.  ``source`` is a vertex id in the
    *relabeled* space (use pg.perm[orig]); ``state`` is the (M, n_loc)
    float32 distance array (inf where unreachable)."""
    cfg = config or EngineConfig()

    def make_step(g):
        def step(state, i):
            dist, active = state
            inbox, stats = broadcast(g, dist, active, op="min",
                                     relay="add_w",
                                     use_mirroring=cfg.use_mirroring,
                                     backend=cfg.backend)
            upd = g.vmask & (inbox < dist)
            new = torch.where(upd, inbox, dist)
            return (new, upd), ~g.gany(upd), stats
        return step

    def init(g):
        is_src = g.local_ids() == source
        return (torch.where(g.vmask & is_src, 0.0, float("inf")).to(
            torch.float32), is_src)

    if cfg.devices is None:
        st, stats, n, _ = bsp.run(make_step(pg), init(pg), max_supersteps)
        return RunResult(state=st[0], stats=stats, n_supersteps=n)
    st, stats, n, _, info = exec_mod.run_sharded(
        pg, make_step, init, max_supersteps, devices=cfg.devices,
        device=device, final=lambda s: s[0],
        plan_kinds=exec_mod.broadcast_plan_kinds(cfg.backend,
                                                 cfg.use_mirroring),
        pipeline=cfg.pipeline)
    return RunResult(state=st, stats=stats, n_supersteps=n, sharded=info)
