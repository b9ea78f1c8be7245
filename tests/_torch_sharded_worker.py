"""The ranks of ``tests/test_torch_sharded.py`` and
``tests/test_torch_sharded_mesh.py``: spawned processes that join a gloo
group and run a whole matrix of sharded jobs, so each world size pays the
start-up once.  This module imports neither JAX nor the JAX package
(every rank imports it); the test modules compare what rank 0 and every
rank write against the single-device runs.

A job spec (pickled by the test) holds partitions as ``structs.to_numpy``
fields and jobs ``name -> (partition, EngineConfig fields, algo,
params)``; the fields may name ``devices`` (an int or an ``(H, T)`` mesh
of the world size; default the world size); ``params`` ``{"attr":
"ramp"}`` stands for the attribute ``3 * arange(n_pad)``.  ``exchange``
names the partition of the routed exchanges at a forced small cap, and
``pipelined`` a ``(partition, devices)`` on which they also run at caps
``PIPE_CAPS``, pipelined and not.
"""
import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.core import channels
from repro_torch.core import exec as texec
from repro_torch.graph import structs
from repro_torch.launch import mesh as meshlib

GROUP_TIMEOUT_S = 90
HOT = 40                  # lanes of a rank aimed at rank 0's slots
LANES = 64
CAP = 8                   # the forced round cap: HOT lanes take 5 rounds
PIPE_CAPS = (1, 8)        # the pipelined exchanges' forced caps
IMAX = np.iinfo(np.int32).max


def ramp(pg) -> torch.Tensor:
    return 3 * torch.arange(pg.n_pad, dtype=torch.float32).view(pg.M,
                                                                pg.n_loc)


def job_params(pg, params: dict) -> dict:
    if params.get("attr") == "ramp":
        return dict(params, attr=ramp(pg))
    if params.get("source") == "perm0":
        return dict(params, source=int(pg.perm[0]))
    return params


def to_host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return tuple(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def lanes_of(rank: int, n_pad: int, loc_n: int):
    """One rank's routed-exchange lanes: HOT of LANES aimed at rank 0's
    slots (a hot destination), some invalid; rank 1 has none."""
    rng = np.random.RandomState(100 + rank)
    if rank == 1:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, bool))
    t = rng.randint(0, n_pad, LANES)
    t[:HOT] = rng.randint(0, loc_n, HOT)
    vals = rng.randint(-1000, 1000, LANES).astype(np.int32)
    valid = rng.rand(LANES) < 0.85
    return t, vals, valid


def gather_inputs(M: int, n_loc: int, R: int = 12):
    """Global (M, n_loc) values and (M, R) request rows for the row
    gather; row 0 of every rank's block has every request masked, and some
    requests aim at one hot target."""
    rng = np.random.RandomState(7)
    n_pad = M * n_loc
    vals = rng.randint(-50, 50, (M, n_loc)).astype(np.int32)
    targets = rng.randint(0, n_pad, (M, R)).astype(np.int32)
    targets[:, :4] = 3
    tmask = rng.rand(M, R) < 0.8
    return vals, targets, tmask


def fetch_lanes(sg, t):
    """The routed fetch's global values (``5 * id - 7``), this rank's rows
    of them, and its targets with three out-of-range ones."""
    n_pad, loc_n = sg.n_pad, sg.m_loc * sg.n_loc
    lo = sg.w0 * sg.n_loc
    glob = np.arange(n_pad, dtype=np.int32) * 5 - 7
    vals = torch.as_tensor(glob[lo:lo + loc_n].reshape(sg.m_loc, sg.n_loc))
    tf = t.clone()
    if len(tf):
        tf[HOT:HOT + 3] = torch.tensor([-1, n_pad, n_pad + 5])
    return glob, vals, tf


def exchange_cases(sg) -> dict:
    """The routed exchanges at a forced small cap, on this rank's lanes,
    with what a plain scatter / read of every rank's lanes gives."""
    n_pad, loc_n = sg.n_pad, sg.m_loc * sg.n_loc
    lo = sg.w0 * sg.n_loc
    out = {}
    t, v, ok = (torch.as_tensor(a) for a in lanes_of(sg.rank, n_pad, loc_n))
    for op in ("min", "sum"):
        got = texec._routed_scatter_combine(sg, t, v, ok, op, cap=CAP)
        want = np.full(n_pad, IMAX if op == "min" else 0, np.int32)
        for r in range(sg.D):
            tr, vr, okr = lanes_of(r, n_pad, loc_n)
            red = np.minimum if op == "min" else np.add
            red.at(want, tr[okr], vr[okr])
        out[f"scatter_{op}"] = (got.numpy(), want[lo:lo + loc_n])
    out["scatter_rounds"] = list(sg.rounds)

    glob, vals, tf = fetch_lanes(sg, t)
    sg.rounds = []
    got = texec._routed_fetch(sg, vals, tf, ok, cap=CAP)
    inb = ok & (tf >= 0) & (tf < n_pad)
    want = np.where(inb.numpy(), glob[tf.clamp(0, n_pad - 1).numpy()], 0)
    out["fetch"] = (got.numpy(), want)
    out["fetch_rounds"] = list(sg.rounds)

    gv, gt, gm = gather_inputs(sg.M, sg.n_loc)
    rows = slice(sg.w0, sg.w0 + sg.m_loc)
    gm = gm.copy()
    gm[sg.w0] = False
    o, s = channels.gather(sg, torch.as_tensor(gv[rows]),
                           torch.as_tensor(gt[rows]), torch.as_tensor(gm[rows]))
    out["gather"] = (o.numpy(), to_host(s), gm)
    return out


def pipelined_cases(pg, devices) -> dict:
    """The routed scatter (min, sum) and fetch on this rank's lanes at
    each cap of ``PIPE_CAPS`` (a ``(cap, cap)`` pair per level on an
    ``(H, T)`` mesh), pipelined and not; with each run's rounds."""
    out = {}
    for pipe in (False, True):
        sg = texec.shard(pg, devices, device="cpu", pipeline=pipe)
        n_pad, loc_n = sg.n_pad, sg.m_loc * sg.n_loc
        t, v, ok = (torch.as_tensor(a)
                    for a in lanes_of(sg.rank, n_pad, loc_n))
        _, vals, tf = fetch_lanes(sg, t)
        for cap in PIPE_CAPS:
            c = (cap, cap) if isinstance(devices, tuple) else cap
            sg.rounds = []
            for op in ("min", "sum"):
                out[(pipe, cap, f"scatter_{op}")] = \
                    texec._routed_scatter_combine(sg, t, v, ok, op,
                                                  cap=c).numpy()
            out[(pipe, cap, "fetch")] = texec._routed_fetch(
                sg, vals, tf, ok, cap=c).numpy()
            out[(pipe, cap, "rounds")] = list(sg.rounds)
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
        parts = {k: structs.from_numpy(v, device="cpu")
                 for k, v in spec["partitions"].items()}
        results = {}
        for name, (part, cfg, algo, params) in spec["jobs"].items():
            pg = parts[part]
            res = api.Engine(device="cpu", **dict({"devices": D}, **cfg)
                             ).run(algo, pg, **job_params(pg, params))
            results[name] = {"state": to_host(res.state),
                             "stats": res.stats,
                             "n": res.n_supersteps,
                             "history": to_host(res.history),
                             "sharded": res.sharded}
        if spec.get("exchange"):
            sg = texec.shard(parts[spec["exchange"]], D, device="cpu")
            results["exchange"] = exchange_cases(sg)
        if spec.get("pipelined"):
            part, devices = spec["pipelined"]
            results["pipelined"] = pipelined_cases(parts[part], devices)
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(results, f)
    finally:
        meshlib.destroy()
