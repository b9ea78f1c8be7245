"""One run of one cell: load, warm up, the measured window, the check.

1. Load: the configuration's generator makes its graph on the device
   (the graph is the configuration's, like a data set's file: its seed is
   in the configuration), the arcs are dealt in an order drawn from the
   run's seed, and the program partitions them (``Engine.partition``) with
   the configuration's ``EngineConfig``, M and tau.  Every seed so gives
   the program the same work, in another order.
2. One untimed warm job builds the plans and grows the caching allocator.
3. Jobs run back to back (a closed loop, one client) until ``seconds``
   have passed; each is one ``Engine.run(algo, pg, **params)``, ending in
   the job's own host read and a synchronise.
4. Once the window has closed, the peak memory is read and the program's
   state freed, the graph is made again from the seed, and the plain
   reference judges a sample of the window's answers drawn from the seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import inspect
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import spec as speclib
from perfbench.harness import trace as tracelib

#: answers of the window held to the reference: a uniform sample drawn
#: from the seed, and the last answer besides
SAMPLE = 16
#: the longest window a traced run profiles: reading the profiler's events
#: takes about twice the window (a 51-s window of road.sv: ~100 s)
TRACE_SECONDS = 20.0


@dataclasses.dataclass
class Job:
    start: float
    end: float
    n_supersteps: int
    stats: Dict[str, int]

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Run:
    """What the metric readers see of one run."""
    cell: speclib.Cell
    n: int
    arcs: int
    jobs: List[Job]
    setup: Dict[str, float]          # setup_s, partition_s, warmup_s, ...
    trace: Optional[tracelib.Trace]
    check: Dict[str, float]
    checked: int
    failed: int
    peak_bytes: int
    device: torch.device
    device_kind: str                 # torch.cuda.get_device_name, or "cpu"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fingerprint(arcs: dict) -> int:
    """A checksum of the arcs, so that the graph made again for the check
    is known to be the one the program was given."""
    n = arcs["n"]
    key = (arcs["src"].to(torch.int64) * n + arcs["dst"].to(torch.int64))
    pos = torch.arange(key.numel(), device=key.device, dtype=torch.int64)
    return int(((key % 1000003) * (pos % 999983 + 1)).sum().item())


def make_graph(cell: speclib.Cell, seed: int, device: torch.device) -> dict:
    """The configuration's graph, its arcs in an order drawn from
    ``seed``."""
    spec = cell.config["graph"]
    arcs = cell.generator().generate(spec, int(spec["seed"]), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    order = torch.randperm(arcs["src"].numel(), generator=gen, device=device)
    for k in ("src", "dst", "weight"):
        if arcs.get(k) is not None:
            arcs[k] = arcs[k][order]
    sync(device)
    return arcs


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed; the last answer is always kept besides."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept: Dict[int, torch.Tensor] = {}
        self.last: Optional[tuple] = None

    def offer(self, i: int, state: torch.Tensor) -> None:
        if i < self.k:
            self.kept[i] = state.clone()
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                victim = sorted(self.kept)[j]
                del self.kept[victim]
                self.kept[i] = state.clone()
        self.last = (i, state)

    def answers(self) -> Dict[int, torch.Tensor]:
        out = dict(self.kept)
        if self.last is not None and self.last[0] not in out:
            out[self.last[0]] = self.last[1]
        return out


def _tracer(cell: speclib.Cell, algo_module: str) -> tracelib.Tracer:
    ranges = dict(tracelib.BASE_RANGES)
    ranges.update(tracelib.channel_ranges(algo_module))
    hooks = {}
    for m in cell.metrics_of("per_layer"):
        reader = m.reader(cell.bench)
        for target, name in getattr(reader, "RANGES", {}).items():
            ranges[target] = name
            if hasattr(reader, "on_call"):
                hooks[target] = (m.name, reader.on_call)
    return tracelib.Tracer(ranges, hooks)


@dataclasses.dataclass
class Loaded:
    """A cell's graph partitioned by the program, and what the check needs
    to find it again."""
    engine: object
    pg: object
    algo: str
    params: dict
    max_supersteps: int
    n: int
    arcs: int
    checksum: int                    # the arcs' fingerprint
    slot: np.ndarray                 # the program's slot of each vertex
    n_pad: int


def load(cell: speclib.Cell, seed: int, dev: torch.device,
         setup: Dict[str, float]) -> Loaded:
    """Make the graph, dealt by the seed, and partition it with the cell's
    engine configuration; the seconds of each step go into ``setup``
    (``init_s``: the program's import and the device's context)."""
    t = time.perf_counter()
    from repro_torch import api
    from repro_torch.core import cost_model
    from repro_torch.graph import structs
    torch.zeros(1, device=dev)
    sync(dev)
    setup["init_s"] = time.perf_counter() - t
    eng_cfg = cell.config["engine"]
    algo = cell.traffic["algo"]
    params = dict(cell.traffic.get("params", {}))
    max_ss = params.get("max_supersteps", inspect.signature(
        importlib.import_module(api.ALGORITHMS[algo]).run).parameters[
            "max_supersteps"].default)
    t = time.perf_counter()
    arcs = make_graph(cell, seed, dev)
    n, n_arcs = arcs["n"], int(arcs["src"].numel())
    checksum = fingerprint(arcs)
    deg = torch.bincount(arcs["src"], minlength=n).cpu().numpy()
    weight = arcs.get("weight")
    g = structs.Graph(n, arcs["src"].cpu().numpy(),
                      arcs["dst"].cpu().numpy(),
                      None if weight is None else weight.cpu().numpy())
    del arcs, weight
    setup["generate_s"] = time.perf_counter() - t
    M = int(eng_cfg["M"])
    tau = eng_cfg["tau"]
    if tau == "choose_tau":
        tau = cost_model.choose_tau(deg, M)
    engine = api.Engine(api.EngineConfig(**eng_cfg["config"]), device=dev)
    t = time.perf_counter()
    pg = engine.partition(g, M, tau=tau, seed=int(eng_cfg["partition_seed"]))
    sync(dev)
    setup["partition_s"] = time.perf_counter() - t
    return Loaded(engine, pg, algo, params, int(max_ss), n, n_arcs,
                  checksum, np.asarray(pg.perm), pg.n_pad)


def judge(cell: speclib.Cell, seed: int, dev: torch.device, ld: Loaded,
          answers: Dict[int, torch.Tensor]) -> Dict[int, Dict[str, float]]:
    """Make the graph again from the seed and hold each answer to the
    plain reference: the numbers of each.  Call it once the program's
    state is freed: the reference runs on the same device."""
    arcs = make_graph(cell, seed, dev)
    if fingerprint(arcs) != ld.checksum:
        raise RuntimeError("the graph made again for the check differs from "
                           "the one the program was given")
    ref = cell.reference()
    expected = ref.expected(arcs, ld.params)
    del arcs
    slot = torch.as_tensor(ld.slot, device=dev)
    return {i: ref.compare(expected, ref.answer(answers[i], slot, ld.n_pad))
            for i in sorted(answers)}


def free_program(ld: Loaded, dev: torch.device) -> None:
    ld.engine = ld.pg = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: speclib.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             algo_run=None) -> Run:
    """Run ``cell`` once.  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock (set-up counts from it); ``algo_run``
    stands in for ``Engine.run`` in the tests that break the timed path.
    A traced run's window lasts at most ``TRACE_SECONDS``."""
    from repro_torch import api

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    setup = {"start_s": time.perf_counter() - t_start}

    # 1. load
    ld = load(cell, seed, dev, setup)
    algo, params, pg = ld.algo, ld.params, ld.pg
    run_job = algo_run or ld.engine.run

    # 2. one untimed warm job
    t = time.perf_counter()
    run_job(algo, pg, **params)
    sync(dev)
    setup["warmup_s"] = time.perf_counter() - t

    tracer = _tracer(cell, api.ALGORITHMS[algo]) if trace else None
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    if tracer is not None:
        tracer.install()
    window = (tracer.window() if tracer is not None
              else contextlib.nullcontext())
    sample = Reservoir(SAMPLE, seed)
    jobs: List[Job] = []
    failed = 0

    # 3. the window
    try:
        with window:
            t0 = time.perf_counter()
            setup["setup_s"] = t0 - t_start
            while True:
                a = time.perf_counter()
                if trace:
                    with record_function(tracelib.JOB):
                        res = run_job(algo, pg, **params)
                else:
                    res = run_job(algo, pg, **params)
                sync(dev)
                b = time.perf_counter()
                jobs.append(Job(a, b, int(res.n_supersteps),
                                {k: int(v) for k, v in res.stats.items()
                                 if np.ndim(v) == 0}))
                failed += int(res.n_supersteps >= ld.max_supersteps)
                sample.offer(len(jobs) - 1, res.state)
                del res
                if b - t0 >= seconds:
                    break
    finally:
        if tracer is not None:
            tracer.uninstall()

    # 4. the check, once the window has closed
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    answers = sample.answers()
    del pg, run_job, sample
    free_program(ld, dev)
    worst: Dict[str, float] = {}
    for numbers in judge(cell, seed, dev, ld, answers).values():
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
    return Run(cell=cell, n=ld.n, arcs=ld.arcs, jobs=jobs, setup=setup,
               trace=tracer.trace if tracer is not None else None,
               check=worst, checked=len(answers), failed=failed,
               peak_bytes=int(peak), device=dev,
               device_kind=(torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"))
