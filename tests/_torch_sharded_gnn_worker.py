"""The ranks of ``tests/test_torch_sharded_gnn.py`` and
``tests/test_torch_sharded_gnn_join.py``: spawned processes that join a
gloo group and run a test file's part of the sharded GNN path's matrix,
so each world size pays the start-up once a file.  This module imports neither JAX nor
the JAX package; the test module holds what every rank writes against the
single-device runs.

A spec (pickled by the test) holds partitions as ``structs.to_numpy``
fields, the inputs (numpy) and a list of jobs ``(kind, name, fields)``:

* ``bcast``: ``channels.broadcast`` on a ShardedGraph built with
  ``fields["devices"]`` (and ``pipeline_chunks``, which forces small caps
  and many plan chunks), for every (op, relay, mirroring, F) of the
  spec's inputs; F=1 also as a scalar payload.  Each rank writes its
  inbox rows and stats.
* ``gspmm``: ``gspmm_sharded`` of the three kinds (gathered out, summed
  stats).
* ``grad``: the gradient of ``sum(join(x) * ct)`` through the sharded
  ``gspmm_join``, this rank's rows.
* ``gcn``: ``train_gcn(devices=..., pipeline=...)`` from the spec's
  params: the loss history and the trained (gathered) params.
* ``fetch``: ``node_embedding_fetch`` on the ShardedGraph, this rank's
  rows.
* ``chunks``: one vector join of each op with ``plan.VEC_CHUNK_BYTES``
  shrunk, counting the vector combines (``plan._combine_rows`` calls on
  (rows, eb, F) lanes) of the join.
* ``apply``: the placement of GCN params whose (M, C) weight is
  replicated: ``place_args`` under the GCN's rule and under the default
  one (this rank's leaves), and ``apply_sharded`` of an identity step on
  the embedding (gathered).
"""
import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import channels
from repro_torch.core import exec as texec
from repro_torch.core import gspmm
from repro_torch.core import plan as planlib
from repro_torch.graph import structs
from repro_torch.launch import mesh as meshlib
from repro_torch.models.embedding import node_embedding_fetch
from repro_torch.train import gcn

GROUP_TIMEOUT_S = 90
OPS = ("sum", "min", "max")
RELAYS = ("none", "mul_w")
FEATS = (1, 5)
#: ``plan.VEC_CHUNK_BYTES`` of the ``chunks`` job: a few rows a chunk
SMALL_CHUNK_BYTES = 1 << 13


def rows_of(sg, x: np.ndarray) -> torch.Tensor:
    """This rank's rows of a global (M, ...) numpy array."""
    return torch.as_tensor(np.ascontiguousarray(x[sg.w0:sg.w0 + sg.m_loc]))


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    return x


def shard_of(pg, f: dict, kinds=("eg", "mir", "all")):
    return texec.shard(pg, f["devices"], kinds, "cpu",
                       pipeline=f.get("pipeline_chunks") is not None,
                       pipeline_chunks=f.get("pipeline_chunks"))


def bcast(pg, f, inputs):
    sg = shard_of(pg, f)
    out = {}
    for op in OPS:
        for F in FEATS:
            x, act = inputs[(f["part"], op, F)]
            xs, acts = rows_of(sg, x), rows_of(sg, act)
            for relay in RELAYS:
                for mir in (True, False):
                    got, st = channels.broadcast(sg, xs, acts, op, relay,
                                                 mir, f["backend"])
                    out[(op, relay, mir, F)] = (host(got), host(st))
                    if F == 1:
                        got, st = channels.broadcast(sg, xs[..., 0], acts,
                                                     op, relay, mir,
                                                     f["backend"])
                        out[(op, relay, mir, 0)] = (host(got), host(st))
    return out


def gspmm_job(pg, f, inputs):
    x = torch.as_tensor(inputs[("gspmm", f["part"])])
    return {kind: host(gspmm.gspmm_sharded(
        pg, kind, x, devices=f["devices"], backend=f["backend"],
        device="cpu")) for kind in gspmm.GSPMM_KINDS}


def grad_job(pg, f, inputs):
    sg = shard_of(pg, f, texec.broadcast_plan_kinds(f["backend"]))
    x, ct = inputs[("grad", f["part"])]
    out = {}
    for kind in ("copy_u_sum", "u_mul_e_sum"):
        xs = rows_of(sg, x).requires_grad_(True)
        y = gspmm.gspmm_join(sg, kind, backend=f["backend"])(xs)
        (g,) = torch.autograd.grad(torch.sum(y * rows_of(sg, ct)), [xs])
        out[kind] = host(g)
    return out


def gcn_job(pg, f, inputs):
    params = gcn.params_from_numpy(inputs[("gcn", f["part"], f["hidden"])],
                                   "cpu")
    info = {}
    got, losses = gcn.train_gcn(
        pg, feat_dim=f["feat_dim"], hidden=f["hidden"],
        n_classes=f["n_classes"], epochs=f["epochs"], lr=f["lr"],
        backend=f["backend"], devices=f["devices"],
        pipeline=f.get("pipeline", False), params=params, device="cpu",
        info=info)
    return {"losses": losses, "params": host(got), "info": info}


def fetch_job(pg, f, inputs):
    sg = shard_of(pg, f, ())
    table, ids, mask = inputs[("fetch", f["part"])]
    got, st = node_embedding_fetch(sg, rows_of(sg, table), rows_of(sg, ids),
                                   rows_of(sg, mask))
    return host(got), host(st)


def chunks_job(pg, f, inputs):
    sg = shard_of(pg, f)
    combine, chunk_bytes = planlib._combine_rows, planlib.VEC_CHUNK_BYTES
    calls = []

    def counted(packed, *a, **kw):
        if packed.dim() == 3:
            calls.append(packed.shape[0])
        return combine(packed, *a, **kw)
    planlib._combine_rows = counted
    planlib.VEC_CHUNK_BYTES = SMALL_CHUNK_BYTES
    out = {}
    try:
        for op in OPS:
            x, act = inputs[(f["part"], op, 5)]
            calls.clear()
            got, st = channels.broadcast(sg, rows_of(sg, x), rows_of(sg, act),
                                         op, "mul_w", True, "pallas")
            out[op] = (host(got), host(st), list(calls))
    finally:
        planlib._combine_rows = combine
        planlib.VEC_CHUNK_BYTES = chunk_bytes
    out["rows"] = {k: (p.n_rows, p.eb, p.nb) for k, p in sg.plans.items()}
    return out


def apply_job(pg, f, inputs):
    """The placement of a GCN-shaped tree whose replicated weight has M
    rows: this rank's leaves under ``train.gcn``'s rule and under
    ``place_args``'s default rule, and the embedding through
    ``apply_sharded`` of an identity step."""
    tree = {k: torch.as_tensor(v) for k, v in
            inputs[("gcn", f["part"], f["hidden"])].items()}
    sg = texec.shard(pg, f["devices"], (), "cpu")
    out = {"gcn": host(texec.place_args(sg, tree, gcn._sharded_leaf(pg))),
           "default": host(texec.place_args(sg, tree)),
           "w0": sg.w0, "m_loc": sg.m_loc}
    got, _, _ = texec.apply_sharded(pg, lambda g: (lambda x: (x, {})),
                                    (tree["emb"],), devices=f["devices"],
                                    device="cpu")
    out["emb"] = host(got)
    return out


JOBS = {"bcast": bcast, "gspmm": gspmm_job, "grad": grad_job,
        "gcn": gcn_job, "fetch": fetch_job, "chunks": chunks_job,
        "apply": apply_job}


def rank_main(rank: int, D: int, store: str, spec_path: str,
              out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=D,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        with open(spec_path, "rb") as fh:
            spec = pickle.load(fh)
        parts = {k: structs.from_numpy(v, device="cpu")
                 for k, v in spec["partitions"].items()}
        results = {}
        for kind, name, f in spec["jobs"]:
            results[name] = JOBS[kind](parts[f["part"]], f, spec["inputs"])
        with open(f"{out_path}.{rank}", "wb") as fh:
            pickle.dump(results, fh)
    finally:
        meshlib.destroy()
