"""Hash-Min connected components (paper §3.3): broadcast the smallest id
seen so far with a min combiner.  The Fig. 1 balance workload.

Labels are int32 end to end, with the int32 identity (iinfo.max): ids above
2^24 are not representable in float32, so a float round trip would merge
distinct components on graphs of that size.
"""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult, check_config
from repro_torch.core import bsp
from repro_torch.core.channels import broadcast
from repro_torch.core.plan import identity_of
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        max_supersteps: int = 10_000,
        record_history: bool = False) -> RunResult:
    """Hash-Min under an EngineConfig.  ``state`` is the (M, n_loc) int32
    label array (min relabeled id of each component)."""
    cfg = config or EngineConfig()
    check_config(cfg)

    def step(state, i):
        minv, active = state
        inbox, stats = broadcast(pg, minv, active, op="min",
                                 use_mirroring=cfg.use_mirroring,
                                 backend=cfg.backend)
        upd = pg.vmask & (inbox < minv)
        new = torch.where(upd, inbox, minv)
        return (new, upd), ~pg.gany(upd), stats

    ids = pg.local_ids().to(torch.int32)
    minv0 = torch.where(pg.vmask, ids, identity_of("min", torch.int32))
    st, stats, n, hist = bsp.run(step, (minv0, pg.vmask), max_supersteps,
                                 record_history=record_history)
    return RunResult(state=st[0], stats=stats, n_supersteps=n, history=hist)
