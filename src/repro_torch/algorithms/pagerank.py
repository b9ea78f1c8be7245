"""PageRank (paper §3.2): broadcast pr/deg with a sum combiner; the
mirroring-vs-combining workload (Fig. 12).  No dangling redistribution, as
in the reference."""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult, check_config
from repro_torch.core import bsp
from repro_torch.core.channels import broadcast
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        n_iters: int = 30, damping: float = 0.85, tol: float = 1e-4,
        record_history: bool = False) -> RunResult:
    """PageRank under an EngineConfig.  ``state`` is the (M, n_loc)
    float32 rank vector.  It halts once no rank moves by ``tol`` or more
    (``tol=0`` runs exactly ``n_iters`` supersteps)."""
    cfg = config or EngineConfig()
    check_config(cfg)
    n = pg.n
    deg = torch.clamp(pg.deg, min=1)
    active = pg.vmask & (pg.deg > 0)

    def step(pr, i):
        contrib = torch.where(pg.vmask, pr / deg, 0.0)
        inbox, stats = broadcast(pg, contrib, active, op="sum",
                                 use_mirroring=cfg.use_mirroring,
                                 backend=cfg.backend)
        new_pr = torch.where(pg.vmask, (1 - damping) / n + damping * inbox,
                             0.0)
        delta = pg.gmax((new_pr - pr).abs().max())
        return new_pr, delta < tol, stats

    pr0 = torch.where(pg.vmask, 1.0 / n, 0.0).to(torch.float32)
    st, stats, nss, hist = bsp.run(step, pr0, n_iters,
                                   record_history=record_history)
    return RunResult(state=st, stats=stats, n_supersteps=nss, history=hist)
