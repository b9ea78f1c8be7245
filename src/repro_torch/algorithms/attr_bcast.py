"""Attribute broadcast (paper §3.1): annotate every adjacency-list entry
(u in Γout(v)) with a(u).  The pure request-respond microbenchmark of
Fig. 13: per edge, v requests a(u) from u's owner; Ch_req dedups the
requests per (worker, target)."""
from __future__ import annotations

import torch

from repro_torch.api import EngineConfig, RunResult, check_config
from repro_torch.core import bsp
from repro_torch.core.channels import gather_edges
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        attr: torch.Tensor) -> RunResult:
    """Attribute broadcast under an EngineConfig.  ``attr`` is an
    (M, n_loc) vertex attribute on ``pg``'s device; ``state`` is the
    per-edge attribute aligned with pg.all_dst: (M, A_loc) in the padded
    layout, (E,) in csr.  stats['msgs_basic'] is the 3-superstep Pregel
    cost (request + response per edge, 2|E| messages); stats['msgs_rr']
    the deduplicated Ch_req cost, identical across layouts.

    Ch_req is a pure gather with no combine stage, so ``backend`` does
    not change the path."""
    check_config(config or EngineConfig())
    out, stats = gather_edges(pg, attr, pg.all_dst, pg.all_mask)
    return RunResult(state=out, stats=bsp.finalize_totals(stats),
                     n_supersteps=1)
