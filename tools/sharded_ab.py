"""Time the scalar sharded executor of one or more source trees, one
process per tree in the order given, so that two versions are compared
within one machine:

    python3 tools/sharded_ab.py --tree A=build/parent --tree B=. --order ABBA

Each process imports ``repro_torch`` from its tree's ``src`` and runs the
six graph algorithms on the partition of ``chip_smoke.py``'s main path
(the normalized powerlaw graph, n=4M by default, M=32 workers, csr layout,
pallas backend, hash balance) on the sharded executor over a process group
of world size 1 (NCCL on a CUDA card, gloo on the CPU), on the 1-D mesh
and on the (1, 1) mesh (``--algos`` and ``--meshes`` choose fewer): one
untimed run, then ``--reps`` runs timed (CUDA events on the card, the host
clock on the CPU) and, with ``--profile`` on the card, one run under
``torch.profiler`` (its device busy time and the operators with the most
device time of their own).  The first process builds
the graph and the partition and leaves them in ``--cache`` as numpy
arrays for the others.  Prints one ``[ab]`` line a (tree, mesh,
algorithm) and, last, one JSON object of every reading.
"""
import argparse
import datetime
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ALGOS = ("hashmin", "pagerank", "sssp", "sv", "msf", "attr_bcast")
MESHES = {"1-D": 1, "mesh 1x1": (1, 1)}


def profiled(torch, fn, top: int = 8) -> dict:
    """One run of ``fn`` under torch.profiler: its wall ms, the device
    busy ms (every kernel's time), and the ``top`` operators by device
    time of their own."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda) / 1e3
    ops = [e for e in prof.key_averages() if e.device_type != cuda
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall, "busy_ms": busy,
            "ops": [(e.key, e.count, e.self_device_time_total / 1e3)
                    for e in ops[:top]]}


def partition(args, dev):
    """The main path's graph and partition, built once and cached."""
    from repro_torch import api
    from repro_torch.core import cost_model
    from repro_torch.graph import generators as gen
    from repro_torch.graph import structs
    from repro_torch.train.gcn import normalize_adjacency
    cache = Path(args.cache)
    if cache.exists():
        with open(cache, "rb") as fh:
            return structs.from_numpy(pickle.load(fh), device=dev), False
    g = normalize_adjacency(gen.powerlaw(args.n, avg_deg=8, seed=args.seed,
                                         weighted=True).symmetrized())
    tau = cost_model.choose_tau(g.out_degrees(), args.workers)
    eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                     device=dev)
    pg = eng.partition(g, args.workers, tau=tau, seed=args.seed)
    cache.parent.mkdir(parents=True, exist_ok=True)
    with open(cache, "wb") as fh:
        pickle.dump(structs.to_numpy(pg), fh, protocol=4)
    return pg, True


def worker(args) -> None:
    """One tree's readings, written to ``args.out`` as JSON."""
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.launch import mesh as meshlib
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    pg, built = partition(args, dev)
    attr = 3 * torch.arange(pg.n_pad, dtype=torch.float32,
                            device=dev).view(pg.M, pg.n_loc)
    params = {"hashmin": {}, "pagerank": {"n_iters": 30, "tol": 0.0},
              "sssp": {"source": int(pg.perm[0])}, "sv": {}, "msf": {},
              "attr_bcast": {"attr": attr}}

    def timed(fn):
        if not cuda:
            t0 = time.perf_counter()
            return fn(), (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    dist.init_process_group(
        "nccl" if cuda else "gloo", store=dist.HashStore(), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    out = {"tree": args.src, "built_graph": built, "n": pg.n, "runs": []}
    try:
        for mesh in args.meshes.split(","):
            eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                             devices=MESHES[mesh], device=dev)
            for algo in args.algos.split(","):
                def run():
                    return eng.run(algo, pg, **params[algo])
                run()                                   # untimed
                ms = []
                for _ in range(args.reps):
                    res, t = timed(run)
                    ms.append(t / res.n_supersteps)
                msgs = {k: int(v) for k, v in res.stats.items()
                        if k.startswith("msgs_")}
                entry = {"mesh": mesh, "algo": algo,
                         "supersteps": int(res.n_supersteps),
                         "ms_superstep": ms, "msgs": msgs}
                print(f"[ab] {args.tag} {mesh} {algo}: "
                      f"{res.n_supersteps} supersteps, ms a superstep "
                      + " ".join(f"{x:.3f}" for x in ms), flush=True)
                if args.profile and cuda:
                    entry["profile"] = prof = profiled(torch, run)
                    print(f"[ab] {args.tag} {mesh} {algo} profiled: wall "
                          f"{prof['wall_ms']:.3f} ms, device busy "
                          f"{prof['busy_ms']:.3f} ms; "
                          + "; ".join(f"{k} x{n} {t:.3f}"
                                      for k, n, t in prof["ops"]),
                          flush=True)
                out["runs"].append(entry)
            pg.plan_cache.clear()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        # a tree from before mesh.destroy() destroys the group alone
        getattr(meshlib, "destroy", dist.destroy_process_group)()
    with open(args.out, "w") as fh:
        json.dump(out, fh)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="TAG=DIR, a source tree (repeatable)")
    ap.add_argument("--order", default="ABBA",
                    help="the tags in the order their processes run")
    ap.add_argument("--n", type=int, default=4_000_000)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--algos", default=",".join(ALGOS))
    ap.add_argument("--meshes", default=",".join(MESHES))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache", default=str(ROOT / "build" / "ab_graph.pkl"))
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds a process may take")
    # one process's own arguments
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.src:
        worker(args)
        return
    trees = dict(t.split("=", 1) for t in args.tree)
    if not trees or set(args.order) - set(trees):
        ap.error(f"--order {args.order!r} names a tag without a --tree")
    if os.path.exists(args.cache):
        os.remove(args.cache)
    results = []
    try:
        for i, tag in enumerate(args.order):
            out = f"{args.cache}.{i}.json"
            cmd = [sys.executable, __file__, "--src", trees[tag], "--tag",
                   tag, "--out", out, "--n", str(args.n), "--workers",
                   str(args.workers), "--seed", str(args.seed), "--reps",
                   str(args.reps), "--device", args.device, "--cache",
                   args.cache, "--algos", args.algos, "--meshes",
                   args.meshes] + (["--profile"] if args.profile else [])
            t0 = time.perf_counter()
            subprocess.run(cmd, check=True, timeout=args.timeout)
            with open(out) as fh:
                res = json.load(fh)
            os.remove(out)
            res.update(tag=tag, seconds=time.perf_counter() - t0)
            results.append(res)
            print(f"[ab] process {i} ({tag}) in {res['seconds']:.1f} s",
                  flush=True)
    finally:
        if os.path.exists(args.cache):
            os.remove(args.cache)
    print(json.dumps({"ab": results}))


if __name__ == "__main__":
    main()
