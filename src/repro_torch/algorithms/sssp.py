"""Single-source shortest paths (paper §5, "Handling Edge Fields"): the
message value depends on the edge, so Ch_mir applies relay(msg) — the edge
weight is added at the *mirror* side, Ch_msg at the sender side."""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult, check_config
from repro_torch.core import bsp
from repro_torch.core.channels import broadcast
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        source: int, max_supersteps: int = 10_000) -> RunResult:
    """SSSP under an EngineConfig.  ``source`` is a vertex id in the
    *relabeled* space (use pg.perm[orig]); ``state`` is the (M, n_loc)
    float32 distance array (inf where unreachable)."""
    cfg = config or EngineConfig()
    check_config(cfg)

    def step(state, i):
        dist, active = state
        inbox, stats = broadcast(pg, dist, active, op="min", relay="add_w",
                                 use_mirroring=cfg.use_mirroring,
                                 backend=cfg.backend)
        upd = pg.vmask & (inbox < dist)
        new = torch.where(upd, inbox, dist)
        return (new, upd), ~pg.gany(upd), stats

    is_src = pg.local_ids() == source
    dist0 = torch.where(pg.vmask & is_src, 0.0, float("inf")).to(
        torch.float32)
    st, stats, n, _ = bsp.run(step, (dist0, is_src), max_supersteps)
    return RunResult(state=st[0], stats=stats, n_supersteps=n)
