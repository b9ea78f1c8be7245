"""The one front door of the port: ``Engine`` + ``EngineConfig`` +
``RunResult`` (the counterpart of ``repro.api``).

    from repro_torch.api import Engine

    eng = Engine(backend="pallas", layout="csr")        # runs on the GPU
    res = eng.run("hashmin", g, M=32)
    res.state, res.stats, res.n_supersteps, res.history

``EngineConfig`` has the reference's fields and config strings, so one
config drives both packages.  The device is an argument of ``Engine``
(default ``"cuda"``; without CUDA it raises unless ``device="cpu"``).

``devices=D`` (an int) runs the graph algorithms on the sharded executor
(``core/exec.py``): one process a device, each calling ``Engine.run`` with
its own ``device`` after initializing the default ``torch.distributed``
process group of world size D (NCCL between GPUs, gloo between CPU
processes; ``launch/graph_run.py --devices D`` does this).  The engine
then partitions on the host, and each rank moves only its own slice of the
tables to its device.  ``devices=(H, T)`` runs them on the (hosts,
per_host) mesh over a group of world size H*T (``graph_run --devices D
--hosts H``), ``pipeline=True`` double-buffers the sharded exchanges,
and ``balance="split"`` places the physical shards on the ranks by edge
load.  ``run("gcn")`` under ``devices`` trains the GCN on the sharded
executor (``train/gcn.py``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Tuple, Union

import numpy as np

from repro_torch import tracing
from repro_torch.core import cost_model
from repro_torch.graph import structs

#: algo name -> module with the canonical ``run(pg, config, **params)``
ALGORITHMS = {
    "hashmin": "repro_torch.algorithms.hashmin",
    "pagerank": "repro_torch.algorithms.pagerank",
    "sssp": "repro_torch.algorithms.sssp",
    "sv": "repro_torch.algorithms.sv",
    "msf": "repro_torch.algorithms.msf",
    "attr_bcast": "repro_torch.algorithms.attr_bcast",
    "gcn": "repro_torch.train.gcn",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution configuration, orthogonal to any one algorithm (the
    fields of ``repro.api.EngineConfig``).

    ``devices``: None = single-device batched simulation; an int D = the
    sharded executor over D ranks; an ``(H, T)`` pair = the executor on
    the 2-D (hosts, per_host) mesh; ``hosts`` makes ``partition()`` place
    workers host-affinely.  ``pipeline`` double-buffers the sharded
    exchanges (nothing changes on one device).
    """
    backend: str = "dense"          # "dense" | "pallas" channel combine
    layout: str = "padded"          # "padded" | "csr" edge layout
    balance: str = "hash"           # one of graph.partitioner.BALANCES
    devices: Union[int, Tuple[int, int], None] = None
    hosts: Optional[int] = None
    pipeline: bool = False          # double-buffer sharded exchanges
    use_mirroring: bool = True      # Ch_mir for >= tau vertices
    split_factor: float = 1.2       # balance="split" hot-worker factor


def config_of(pg: structs.PartitionedGraph, **overrides) -> EngineConfig:
    """An EngineConfig whose partition-time fields mirror ``pg``."""
    base = dict(layout=pg.layout, balance=pg.balance,
                split_factor=pg.split_factor, hosts=pg.hosts)
    base.update(overrides)
    return EngineConfig(**base)


@dataclasses.dataclass
class RunResult:
    """Uniform algorithm result.  ``state`` is the algorithm's output
    tensor (labels / pr / dist); ``history`` the per-superstep stats when
    recorded, else None; ``jump_reads`` the host reads of MSF's pointer
    jumping loops (None for the other algorithms); ``sharded`` what the
    sharded executor reports of this rank's run (``exec.run_sharded``'s
    ``info``; None on one device)."""
    state: Any
    stats: dict
    n_supersteps: int
    history: Any = None
    jump_reads: Optional[int] = None
    sharded: Optional[dict] = None

    def load_report(self) -> Optional[dict]:
        """Measured per-worker load of this run: the
        ``cost_model.straggler_report`` of the summed ``per_worker_total``
        stats, plus the worker ids carrying the tail.  None when the run
        kept no per-worker stats."""
        per_worker = self.stats.get("per_worker_total")
        if per_worker is None:
            parts = [np.asarray(self.stats[k], np.int64)
                     for k in ("per_worker_basic", "per_worker_combined",
                               "per_worker_mirror")
                     if k in self.stats]
            if not parts:
                return None
            per_worker = sum(parts)
        pw = np.asarray(per_worker, np.int64)
        rep = cost_model.straggler_report(pw)
        rep["per_worker_total"] = pw
        rep["top_workers"] = np.argsort(-pw)[:4].tolist()
        return rep


class Engine:
    """Facade binding an EngineConfig and a device to partitioning and
    algorithm runs."""

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 device: structs.DeviceLike = "cuda", **overrides):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = structs.resolve_device(device)
        if config.devices is not None:
            from repro_torch.core import exec as exec_mod
            exec_mod.world(None, config.devices, self.device)

    def partition(self, g: structs.Graph, M: int,
                  tau: Optional[int] = None, seed: int = 0,
                  perm=None) -> structs.PartitionedGraph:
        """Partition ``g`` onto this engine's device, or, under
        ``devices``, on the host: each rank of the sharded executor moves
        only its own slice to its device."""
        cfg = self.config
        return structs.partition(g, M, tau=tau, seed=seed,
                                 layout=cfg.layout, balance=cfg.balance,
                                 split_factor=cfg.split_factor,
                                 hosts=cfg.hosts, perm=perm,
                                 device=("cpu" if cfg.devices is not None
                                         else self.device))

    def run(self, algo: str, graph, M: Optional[int] = None,
            tau: Optional[int] = None, seed: int = 0,
            **algo_params) -> RunResult:
        """Run ``algo`` on ``graph`` (a PartitionedGraph on this engine's
        device, or a host Graph partitioned on the fly — then ``M`` is
        required).  Under ``devices`` the partition may live anywhere:
        the sharded executor reads only its host tables, and this rank
        runs on the engine's device.  The job is one ``engine.run`` span
        (``repro_torch.tracing``), which carries the counters' changes."""
        if algo not in ALGORITHMS:
            raise ValueError(f"unknown algo {algo!r}; one of "
                             f"{sorted(ALGORITHMS)}")
        sharded = self.config.devices is not None
        if sharded:
            algo_params = dict(algo_params, device=self.device)
        with tracing.span(tracing.JOB, algo=algo):
            if isinstance(graph, structs.PartitionedGraph):
                pg = graph
                if not sharded and pg.device != self.device:
                    raise ValueError(f"the partition lives on {pg.device}, "
                                     f"the engine runs on {self.device}")
            else:
                if M is None:
                    raise ValueError("partitioning a Graph on the fly "
                                     "needs M")
                pg = self.partition(graph, M, tau=tau, seed=seed)
            mod = importlib.import_module(ALGORITHMS[algo])
            return mod.run(pg, self.config, **algo_params)
