"""Attribute broadcast (paper §3.1): annotate every adjacency-list entry
(u in Γout(v)) with a(u).  The pure request-respond microbenchmark of
Fig. 13: per edge, v requests a(u) from u's owner; Ch_req dedups the
requests per (worker, target)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import EngineConfig, RunResult
from repro_torch.core import bsp
from repro_torch.core import exec as exec_mod
from repro_torch.core.channels import gather_edges
from repro_torch.graph.structs import PartitionedGraph


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        attr: torch.Tensor, device=None) -> RunResult:
    """Attribute broadcast under an EngineConfig.  ``attr`` is an
    (M, n_loc) vertex attribute on ``pg``'s device (under ``devices``: on
    any device, each rank takes its rows); ``state`` is the per-edge
    attribute aligned with pg.all_dst: (M, A_loc) in the padded layout,
    (E,) in csr.  stats['msgs_basic'] is the 3-superstep Pregel cost
    (request + response per edge, 2|E| messages); stats['msgs_rr'] the
    deduplicated Ch_req cost, identical across layouts and device counts.

    Ch_req is a pure gather with no combine stage, so ``backend`` does
    not change the path."""
    cfg = config or EngineConfig()

    def make_fn(g):
        def fn(a):
            return gather_edges(g, a, g.all_dst, g.all_mask)
        return fn

    if cfg.devices is None:
        out, stats = make_fn(pg)(attr)
        return RunResult(state=out, stats=bsp.finalize_totals(stats),
                         n_supersteps=1)
    out, stats, info = exec_mod.apply_sharded(
        pg, make_fn, (attr,), devices=cfg.devices, device=device,
        pipeline=cfg.pipeline)
    if pg.layout == "csr":
        # the ranks' edge slices come back with their padding: strip back
        # to the flat (E,) edge order
        counts = np.diff(exec_mod.device_edge_bounds(pg, cfg.devices)["all"])
        cap = out.shape[0] // len(counts)
        out = torch.cat([out[d * cap:d * cap + int(c)]
                         for d, c in enumerate(counts)])
    return RunResult(state=out, stats=bsp.finalize_totals(stats),
                     n_supersteps=1, sharded=info)
