"""The one front door of the port: ``Engine`` + ``EngineConfig`` +
``RunResult`` (the counterpart of ``repro.api``).

    from repro_torch.api import Engine

    eng = Engine(backend="pallas", layout="csr")        # runs on the GPU
    res = eng.run("hashmin", g, M=32)
    res.state, res.stats, res.n_supersteps, res.history

``EngineConfig`` has the reference's fields and config strings, so one
config drives both packages.  The device is an argument of ``Engine``
(default ``"cuda"``; without CUDA it raises unless ``device="cpu"``).  This
slice runs on one device: ``devices``, ``pipeline`` and the algorithms not
ported yet raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Tuple, Union

import numpy as np

from repro_torch.core import cost_model
from repro_torch.graph import structs

#: algo name -> module with the canonical ``run(pg, config, **params)``
ALGORITHMS = {
    "hashmin": "repro_torch.algorithms.hashmin",
    "pagerank": "repro_torch.algorithms.pagerank",
    "sssp": "repro_torch.algorithms.sssp",
}
#: algorithms of the reference that later slices of the port bring
LATER = {
    "sv": "the request-respond (Ch_req) slice",
    "msf": "the request-respond (Ch_req) slice",
    "attr_bcast": "the request-respond (Ch_req) slice",
    "gcn": "the gSpMM and GCN slice",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution configuration, orthogonal to any one algorithm (the
    fields of ``repro.api.EngineConfig``).

    ``devices``: None = single-device batched simulation (the only mode of
    this slice); ``hosts`` makes ``partition()`` place workers
    host-affinely.
    """
    backend: str = "dense"          # "dense" | "pallas" channel combine
    layout: str = "padded"          # "padded" | "csr" edge layout
    balance: str = "hash"           # one of graph.partitioner.BALANCES
    devices: Union[int, Tuple[int, int], None] = None
    hosts: Optional[int] = None
    pipeline: bool = False          # double-buffer sharded exchanges
    use_mirroring: bool = True      # Ch_mir for >= tau vertices
    split_factor: float = 1.2       # balance="split" hot-worker factor


def check_config(cfg: EngineConfig) -> None:
    """Raise for what this slice of the port does not run (no fallback)."""
    if cfg.devices is not None:
        raise NotImplementedError(
            f"EngineConfig(devices={cfg.devices!r}): the sharded executor "
            "comes with a later slice of the port; use devices=None")
    if cfg.pipeline:
        raise NotImplementedError(
            "EngineConfig(pipeline=True) pipelines the sharded executor, "
            "which comes with a later slice of the port")


@dataclasses.dataclass
class RunResult:
    """Uniform algorithm result.  ``state`` is the algorithm's output
    tensor (labels / pr / dist); ``history`` the per-superstep stats when
    recorded, else None."""
    state: Any
    stats: dict
    n_supersteps: int
    history: Any = None

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
        check_config(config)
        self.config = config
        self.device = structs.resolve_device(device)

    def partition(self, g: structs.Graph, M: int,
                  tau: Optional[int] = None, seed: int = 0,
                  perm=None) -> structs.PartitionedGraph:
        cfg = self.config
        return structs.partition(g, M, tau=tau, seed=seed,
                                 layout=cfg.layout, balance=cfg.balance,
                                 split_factor=cfg.split_factor,
                                 hosts=cfg.hosts, perm=perm,
                                 device=self.device)

    def run(self, algo: str, graph, M: Optional[int] = None,
            tau: Optional[int] = None, seed: int = 0,
            **algo_params) -> RunResult:
        """Run ``algo`` on ``graph`` (a PartitionedGraph on this engine's
        device, or a host Graph partitioned on the fly — then ``M`` is
        required)."""
        if algo in LATER:
            raise NotImplementedError(f"{algo!r} comes with {LATER[algo]} "
                                      "of the port")
        if algo not in ALGORITHMS:
            raise ValueError(f"unknown algo {algo!r}; one of "
                             f"{sorted(ALGORITHMS)}")
        if isinstance(graph, structs.PartitionedGraph):
            pg = graph
            if pg.device != self.device:
                raise ValueError(f"the partition lives on {pg.device}, "
                                 f"the engine runs on {self.device}")
        else:
            if M is None:
                raise ValueError("partitioning a Graph on the fly needs M")
            pg = self.partition(graph, M, tau=tau, seed=seed)
        mod = importlib.import_module(ALGORITHMS[algo])
        return mod.run(pg, self.config, **algo_params)
