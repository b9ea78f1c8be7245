"""PageRank (paper §3.2): broadcast pr/deg with a sum combiner; the
mirroring-vs-combining workload (Fig. 12).  No dangling redistribution, as
in the reference."""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult
from repro_torch.core import bsp
from repro_torch.core import exec as exec_mod
from repro_torch.core.channels import broadcast
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        n_iters: int = 30, damping: float = 0.85, tol: float = 1e-4,
        record_history: bool = False, device=None) -> RunResult:
    """PageRank under an EngineConfig.  ``state`` is the (M, n_loc)
    float32 rank vector.  It halts once no rank moves by ``tol`` or more
    (``tol=0`` runs exactly ``n_iters`` supersteps).  Under ``devices``
    the sharded sums agree with one device to float round-off."""
    cfg = config or EngineConfig()
    n = pg.n

    def make_step(g):
        deg = torch.clamp(g.deg, min=1)
        active = g.vmask & (g.deg > 0)

        def step(pr, i):
            contrib = torch.where(g.vmask, pr / deg, 0.0)
            inbox, stats = broadcast(g, contrib, active, op="sum",
                                     use_mirroring=cfg.use_mirroring,
                                     backend=cfg.backend)
            new_pr = torch.where(g.vmask,
                                 (1 - damping) / n + damping * inbox, 0.0)
            delta = g.gmax((new_pr - pr).abs().max())
            return new_pr, delta < tol, stats
        return step

    def init(g):
        return torch.where(g.vmask, 1.0 / n, 0.0).to(torch.float32)

    if cfg.devices is None:
        st, stats, nss, hist = bsp.run(make_step(pg), init(pg), n_iters,
                                       record_history=record_history)
        return RunResult(state=st, stats=stats, n_supersteps=nss,
                         history=hist)
    st, stats, nss, hist, info = exec_mod.run_sharded(
        pg, make_step, init, n_iters, record_history=record_history,
        devices=cfg.devices, device=device,
        plan_kinds=exec_mod.broadcast_plan_kinds(cfg.backend,
                                                 cfg.use_mirroring),
        pipeline=cfg.pipeline)
    return RunResult(state=st, stats=stats, n_supersteps=nss, history=hist,
                     sharded=info)
