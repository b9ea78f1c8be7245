"""Minimum spanning forest (paper §3.5): Boruvka with the SEAS optimization
("storing edges at subvertices").  Edges stay distributed at subvertices,
which query their supervertex (request-respond) every round; supervertices
aggregate min-edge picks through the combined scatter channel.

Per round:
  1. every edge endpoint asks the owner of its neighbour for D[v] (Ch_req);
  2. a 3-stage scatter-min elects each component's min edge under the total
     order (w, min(Du, Dv), max(Du, Dv)), so ties cannot create >2-cycles;
  3. mutual picks form conjoined trees; the smaller root becomes the
     supervertex; pointer jumping (more Ch_req) flattens the forest.
     Towards the end a supervertex serves requests from ALL its
     subvertices, the bottleneck the request-respond channel removes.

The reference's ``lax.while_loop`` of pointer jumps is a Python loop here,
with one host read of its "changed" vote per jump (``RunResult.jump_reads``,
and the counter ``host_reads`` of ``repro_torch.tracing``).
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.algorithms.sv import _acc
from repro_torch.api import EngineConfig, RunResult
from repro_torch.core import bsp
from repro_torch.core import exec as exec_mod
from repro_torch.core.channels import gather, gather_edges, scatter_edges
from repro_torch.graph.structs import PartitionedGraph

IMAX = torch.iinfo(torch.int32).max


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        max_rounds: int = 40, device=None) -> RunResult:
    """Boruvka MSF under an EngineConfig.  ``state`` is the tuple (labels
    (M, n_loc) int32, total_weight float32, n_edges int64).  Requires pg
    built from a *weighted, symmetrized* graph.

    Edge-shaped reads and writes (per-edge supervertex queries, min-edge
    election) go through the pg-level channel wrappers, which follow
    ``pg.layout``; state-shaped ones (pointer jumping) are
    layout-independent.  Pointer jumping loops to convergence (the
    reference's ``jump_iters`` is unused there and not taken here); under
    ``devices`` each "changed" vote is global before its host read."""
    cfg = config or EngineConfig()
    backend = cfg.backend
    jump_reads = 0

    def make_step(g):
        vmask = g.vmask
        ids = g.local_ids().to(torch.int32)

        def step(state, i):
            nonlocal jump_reads
            D, total_w, n_edges = state
            stats: dict = {}

            Dv, s = gather_edges(g, D, g.all_dst, g.all_mask)
            stats = _acc(stats, s)
            Du = g.edge_src_values(D, g.all_src, "all")
            cross = g.all_mask & (Dv != Du)

            # --- 3-stage min-edge election per supervertex ---------------
            inf_f = torch.full(ids.shape, float("inf"), dtype=torch.float32,
                               device=ids.device)
            wmin, s = scatter_edges(g, inf_f, Du, g.all_w, cross, "min",
                                    backend=backend)
            stats = _acc(stats, s)
            wmin_e, s = gather_edges(g, wmin, Du, cross)
            stats = _acc(stats, s)
            sel = cross & (g.all_w == wmin_e)

            lo = torch.minimum(Du, Dv)
            hi = torch.maximum(Du, Dv)
            imax_i = torch.full_like(ids, IMAX)
            lomin, s = scatter_edges(g, imax_i, Du, lo, sel, "min",
                                     backend=backend)
            stats = _acc(stats, s)
            lomin_e, s = gather_edges(g, lomin, Du, sel)
            stats = _acc(stats, s)
            sel &= lo == lomin_e

            himin, s = scatter_edges(g, imax_i, Du, hi, sel, "min",
                                     backend=backend)
            stats = _acc(stats, s)
            himin_e, s = gather_edges(g, himin, Du, sel)
            stats = _acc(stats, s)
            sel &= hi == himin_e

            other = torch.where(lo == Du, hi, lo)
            tgt, s = scatter_edges(g, imax_i, Du, other, sel, "min",
                                   backend=backend)
            stats = _acc(stats, s)

            valid = vmask & (tgt != IMAX)
            t_of_t, s = gather(g, tgt, torch.where(valid, tgt, 0), valid)
            stats = _acc(stats, s)
            mutual = valid & (t_of_t == ids)

            add = valid & (~mutual | (ids < tgt))
            total_w = total_w + g.gsum(torch.where(add, wmin, 0.0))
            n_edges = n_edges + g.gsum(add)

            is_root = D == ids
            hookD = torch.where(mutual & (ids < tgt), ids, tgt)
            D1 = torch.where(is_root & valid, hookD, D)

            # --- pointer jumping (subvertices chase the supervertex) -----
            jumps: dict = {}
            Dj = D1
            changed = bool(g.gany(D1 != D))
            jump_reads += 1
            tracing.count("host_reads")
            while changed:
                DD, s = gather(g, Dj, Dj, vmask)
                jumps = _acc(jumps, s)
                changed = bool(g.gany(DD != Dj))
                jump_reads += 1
                tracing.count("host_reads")
                Dj = DD
            if jumps:
                stats = _acc(stats, jumps)

            return (Dj, total_w, n_edges), ~g.gany(valid), stats
        return step

    def init(g):
        dev = g.vmask.device
        return (g.local_ids().to(torch.int32),
                torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))

    if cfg.devices is None:
        st, stats, n, _ = bsp.run(make_step(pg), init(pg), max_rounds)
        return RunResult(state=st, stats=stats, n_supersteps=n,
                         jump_reads=jump_reads)
    st, stats, n, _, info = exec_mod.run_sharded(
        pg, make_step, init, max_rounds, devices=cfg.devices, device=device,
        pipeline=cfg.pipeline)
    return RunResult(state=st, stats=stats, n_supersteps=n,
                     jump_reads=jump_reads, sharded=info)
