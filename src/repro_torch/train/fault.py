"""Fault tolerance and elasticity (the counterpart of
``repro.train.fault``).

* **Checkpoint and restart**: ``checkpoint.save`` is atomic and
  ``checkpoint.restore_or_init`` resumes; the GCN's full-graph epochs
  replay the same data, so a resumed run continues the straight one.
* **Elastic re-mesh**: checkpoints are global host arrays;
  ``checkpoint.resharded`` places them on a rank of any world size.  For
  the graph engine, ``repartition`` rebuilds the layout for a new worker
  count and carries the per-vertex state across by global vertex id.
* **Stragglers**: supersteps are synchronous, so the per-worker load
  imbalance is the straggler damage; ``straggler_report`` measures it.
* **Preemption drills**: ``simulate_preemption`` kills a train loop
  mid-run and resumes it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# straggler_report lives with the rest of the balance model
from repro_torch.core.cost_model import straggler_report  # noqa: F401
from repro_torch.graph.structs import Graph, PartitionedGraph, partition


def repartition(g: Graph, state_by_vertex, old_pg: PartitionedGraph,
                new_M: int, tau=None, seed: int = 0):
    """Elastic re-mesh of a BSP computation: rebuild the partition for
    ``new_M`` workers (on ``old_pg``'s device) and carry per-vertex state
    across by global id.

    ``state_by_vertex``: (old_M, n_loc) tensor or array in the old layout.
    Returns ``(new_pg, new_state)``, the state (new_M, n_loc') as a tensor
    on the input's device (the CPU for an array)."""
    state = torch.as_tensor(state_by_vertex)
    flat = state.detach().cpu().numpy().reshape(-1)[:old_pg.n_pad]
    by_orig = flat[old_pg.perm]     # old layout -> original vertex order
    new_pg = partition(g, new_M, tau=tau, seed=seed, device=old_pg.device)
    new_flat = np.zeros(new_pg.n_pad, flat.dtype)
    new_flat[new_pg.perm] = by_orig
    return new_pg, torch.as_tensor(
        new_flat.reshape(new_pg.M, new_pg.n_loc), device=state.device)


def simulate_preemption(run_steps: Callable[[int, int], list],
                        total_steps: int, kill_at: int):
    """Drive a checkpointed training function through a mid-run kill.

    ``run_steps(start, stop) -> list of losses`` must checkpoint internally
    and resume from its checkpoint directory.  Returns the losses of the
    killed and resumed run, for comparison with a straight one."""
    first = run_steps(0, kill_at)
    resumed = run_steps(kill_at, total_steps)  # a fresh call is a restart
    return first + resumed
