"""The ranks of ``tests/test_torch_service_sharded.py``: spawned processes
that join a gloo group of world size D and each hold a ``GraphService``
on the same graph, running the same client program (a mixed batch, a
fold, another batch, then a batch that ranks other than 0 submit with
other sources: rank 0's queue must be the one served everywhere), then
each scenario of the spec on a service of its own (the elastic
repartition and the profile overflow); a spec without a batch runs its
scenarios alone.  Each rank writes what it
answered.  This module imports neither JAX nor the JAX package.

A spec (pickled by the test) holds the graph (``n``, ``src``, ``dst``,
``w``), the service's keyword arguments, the query batches as (kind,
source) pairs and the delta's arrays; ``scenarios`` maps a name to the
same keys for one more program: a graph, the service's keyword
arguments, a first batch (``first``), a delta and a second batch
(``second``).
"""
import dataclasses
import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import EngineConfig
from repro_torch.core import exec as texec
from repro_torch.core.service import GraphClient, GraphService, Query
from repro_torch.graph import structs
from repro_torch.launch import mesh as meshlib

GROUP_TIMEOUT_S = 90


def answers(results) -> list:
    return [(r.query.kind, r.query.source, r.epoch, r.cached, r.value)
            for r in results]


def batch_record(svc) -> dict:
    lb = dict(svc.last_batch)
    return {"last_batch": lb, "last_pump": dict(svc.last_pump),
            "traces": svc.traces, "epoch": svc.epoch}


def scenario(sc: dict, D: int) -> dict:
    """One scenario's program on a new service: warm, the first batch, a
    fold of the delta, the second batch.  Returns the answers, the
    repartition and executor counts, the profiles and the final
    partition."""
    g = structs.Graph(sc["n"], sc["src"], sc["dst"], sc["w"])
    svc = GraphService(g, config=EngineConfig(
        layout="csr", balance="edges", devices=D), device="cpu",
        **sc["service"])
    svc.warmup()
    client = GraphClient(svc)
    out = {"warm_traces": svc.traces,
           "profile0": dataclasses.asdict(svc.profile)}
    out["first"] = answers(client.request(
        [Query(k, s) for k, s in sc["first"]]))
    out["first_repartitions"] = svc.repartitions
    svc.mutate(structs.EdgeDelta(**sc["delta"]))
    out["second"] = answers(client.request(
        [Query(k, s) for k, s in sc["second"]]))
    out.update(repartitions=svc.repartitions, traces=svc.traces,
               profile=dataclasses.asdict(svc.profile),
               batch=batch_record(svc), pg=structs.to_numpy(svc.pg))
    return out


def client_program(spec: dict, D: int, rank: int) -> dict:
    """The spec's client program on a service of the spec's graph: a
    batch, a fold, the probe and the batch again, then every rank
    submitting the probe with its own sources (only rank 0's queue is
    served).  Returns the answers, batch records and labels."""
    g = structs.Graph(spec["n"], spec["src"], spec["dst"], spec["w"])
    svc = GraphService(g, config=EngineConfig(
        layout="csr", balance="edges", devices=D), device="cpu",
        **spec["service"])
    svc.warmup()
    client = GraphClient(svc)
    out = {"warm_traces": svc.traces}
    ptrs = {k: t.data_ptr() for k, t in texec._tensors(svc.sg)}
    out["pre"] = answers(client.request(
        [Query(k, s) for k, s in spec["batch"]]))
    out["pre_batch"] = batch_record(svc)
    svc.mutate(structs.EdgeDelta(**spec["delta"]))
    out["post"] = answers(client.request(
        [Query(k, s) for k, s in spec["probe"] + spec["batch"]]))
    out["post_batch"] = batch_record(svc)
    out["storage_kept"] = ptrs == {
        k: t.data_ptr() for k, t in texec._tensors(svc.sg)}
    # every rank submits, but only rank 0's queue is served
    mine = spec["probe"] if rank == 0 else [
        (k, (s + 1 + rank) % g.n) for k, s in spec["probe"]]
    tickets = svc.submit([Query(k, s) for k, s in mine])
    svc.pump()
    out["rank0_queue"] = answers([svc.take_result(t) for t in tickets])
    out["labels"] = np.asarray(svc._labels_now()[1])
    return out


def rank_main(rank: int, D: int, store: str, spec_path: str,
              out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=D,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        with open(spec_path, "rb") as f:
            spec = pickle.load(f)
        out = {"rank": dist.get_rank(), "world": dist.get_world_size()}
        if "batch" in spec:
            out.update(client_program(spec, D, rank))
        out["scenarios"] = {name: scenario(sc, D) for name, sc in
                            sorted(spec.get("scenarios", {}).items())}
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        meshlib.destroy()
