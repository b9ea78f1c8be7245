"""Persistent graph-service demo of the port (the counterpart of
``repro.launch.serve_graph``).

    PYTHONPATH=src python -m repro_torch.launch.serve_graph \\
        --n 200000 --workers 32

Boots a :class:`repro_torch.core.service.GraphService` holding a resident
partitioned powerlaw graph on the sharded executor, then:

1. warms the bucket executors (each built once);
2. answers a 64-query mixed batch (landmark SSSP + personalized PageRank
   + ego-component lookups) in one executor run; the service's executor
   counter must stay flat across the batch;
3. streams a 1%-edge-churn ``EdgeDelta``, folded between batches by
   ``fold_delta`` (no re-partition; the resident tables are refilled in
   place), and checks that the counter stays flat, the epoch is 1 and no
   answer straddles the fold;
4. checks post-fold answers against a fresh ``partition()`` of the
   mutated edge list: SSSP allclose, PPR within 1e-5 of a numpy power
   iteration, ego exactly against a component labelling on the host.

``--device`` is the card by default (``cpu`` asks for the CPU).
``--devices D`` runs D ranks, one process each through ``graph_run``'s
rendezvous (NCCL with rank r on ``cuda:r``, gloo on the CPU); the default
1 runs in this process on a group of world size 1.  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import datetime
import tempfile
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the sharded executor, one process each "
                         "(NCCL on cuda:<rank>, gloo on cpu)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64,
                    help="queries per mixed batch")
    ap.add_argument("--buckets", type=int, nargs="+", default=[4, 16, 64],
                    help="query-batch padding buckets (one executor each)")
    ap.add_argument("--churn", type=float, default=0.01,
                    help="fraction of edges removed AND added by the "
                         "streamed mutation")
    ap.add_argument("--ppr-iters", type=int, default=20)
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the fresh-full-partition cross-check "
                         "(for timing-only runs)")
    return ap


def mixed_batch(n, size, seed):
    """``size`` queries: a third SSSP, a third PPR, the rest ego, at
    sources drawn with numpy from ``seed``."""
    from repro_torch.core.service import Query
    rng = np.random.RandomState(seed)
    kinds = (["sssp"] * (size // 3) + ["ppr"] * (size // 3)
             + ["ego"] * (size - 2 * (size // 3)))
    return [Query(k, int(s)) for k, s in zip(kinds, rng.randint(0, n,
                                                                size=size))]


def churn_delta(g, frac, seed):
    """Remove ``frac`` of the undirected edges and add as many random
    ones, both directions."""
    from repro_torch.graph.structs import EdgeDelta
    rng = np.random.RandomState(seed + 1)
    half = g.m // 2            # symmetrized: mutate lo<hi halves, mirror
    k = max(int(half * frac), 1)
    ridx = rng.choice(half, size=k, replace=False)
    lo = np.minimum(g.src, g.dst)
    hi = np.maximum(g.src, g.dst)
    key = np.unique(lo.astype(np.int64) * g.n + hi)
    rs, rd = key[ridx] // g.n, key[ridx] % g.n
    a_s = rng.randint(0, g.n, size=k)
    a_d = rng.randint(0, g.n, size=k)
    keep = a_s != a_d
    a_w = rng.rand(int(keep.sum())).astype(np.float32) + 0.01
    return EdgeDelta(add_src=a_s[keep], add_dst=a_d[keep], add_w=a_w,
                     rem_src=rs, rem_dst=rd).symmetrized()


def components(n, src, dst) -> np.ndarray:
    """Each vertex's component as its least vertex id, on the host (min
    propagation over the edges with pointer jumping)."""
    order = np.argsort(dst, kind="stable")
    s, d = np.asarray(src)[order], np.asarray(dst)[order]
    heads = np.flatnonzero(np.r_[True, d[1:] != d[:-1]]) if len(d) else []
    lab = np.arange(n)
    while True:
        nxt = lab.copy()
        if len(d):
            nxt[d[heads]] = np.minimum(lab[d[heads]],
                                       np.minimum.reduceat(lab[s], heads))
        nxt = nxt[nxt]
        if np.array_equal(nxt, lab):
            return lab
        lab = nxt


def ppr_power(g, src, alpha, iters) -> np.ndarray:
    """Personalized PageRank seeded at ``src``: the float64 power
    iteration the service's PPR lanes compute."""
    deg = np.bincount(g.src, minlength=g.n)
    pr = np.zeros(g.n)
    pr[src] = 1.0
    restart = pr.copy()
    for _ in range(iters):
        contrib = np.where(deg > 0, pr / np.maximum(deg, 1), 0.0)
        inbox = np.zeros(g.n)
        np.add.at(inbox, g.dst, contrib[g.src])
        pr = alpha * restart + (1 - alpha) * inbox
    return pr


def run(args, rank: int = 0, device=None) -> None:
    """The demo on this rank of the default process group (world size
    ``--devices``), on ``device`` (default ``--device``)."""
    from repro_torch.api import Engine, EngineConfig
    from repro_torch.core.service import GraphClient, GraphService, Query
    from repro_torch.graph import generators
    from repro_torch.graph.structs import canonical_labels, partition

    show = print if rank == 0 else (lambda *a, **k: None)
    device = args.device if device is None else device
    g = generators.powerlaw(args.n, avg_deg=args.avg_deg, seed=args.seed,
                            weighted=True).symmetrized()
    cfg = EngineConfig(layout="csr", balance="edges", devices=args.devices)
    t0 = time.time()
    svc = GraphService(g, M=args.workers, config=cfg, buckets=args.buckets,
                       ppr_iters=args.ppr_iters, seed=args.seed,
                       device=device)
    client = GraphClient(svc)
    show(f"[serve-graph] resident graph n={g.n} m={g.m} M={args.workers} "
         f"tau={svc.pg.tau} devices={args.devices} device={svc.device} "
         f"partitioned in {time.time() - t0:.2f}s")

    t0 = time.time()
    svc.warmup()
    warm_traces = svc.traces
    show(f"[serve-graph] warmup: {warm_traces} executors (buckets "
         f"{svc.buckets} + components) in {time.time() - t0:.2f}s")

    # -- 2. the 64-query mixed batch, one executor run ---------------------
    batch = mixed_batch(g.n, args.batch, args.seed)
    t0 = time.time()
    results = client.request(batch)
    dt = time.time() - t0
    if svc.traces != warm_traces:
        raise RuntimeError(f"admission built {svc.traces - warm_traces} "
                           "executors after warmup")
    lp = svc.last_pump
    if args.batch <= 3 * max(args.buckets) and lp["slices"] != 1:
        raise RuntimeError(f"expected one executor run, got {lp['slices']}")
    show(f"[serve-graph] {len(results)} mixed queries "
         f"(sssp={lp['lanes_sssp']} ppr={lp['lanes_ppr']} "
         f"ego={sum(r.query.kind == 'ego' for r in results)}) in "
         f"{dt:.2f}s, {lp['slices']} executor run(s), "
         f"bucket={svc.last_batch['bucket']}, "
         f"{lp['n_supersteps']} supersteps, no executor built, "
         f"{len(results) / dt:.1f} q/s")

    # -- 3. streamed churn, folded between batches -------------------------
    delta = churn_delta(g, args.churn, args.seed)
    svc.mutate(delta)
    probe = [Query("sssp", 17), Query("ppr", 23), Query("ego", 5)]
    t0 = time.time()
    post = client.request(probe + batch)      # fold + serve in one pump
    dt = time.time() - t0
    if svc.epoch != 1 or any(r.epoch != 1 for r in post):
        raise RuntimeError(f"epoch {svc.epoch}, answers at epochs "
                           f"{sorted({r.epoch for r in post})}: a batch "
                           "straddled the fold")
    if svc.traces != warm_traces:
        raise RuntimeError(f"the fold built {svc.traces - warm_traces} "
                           "executors")
    show(f"[serve-graph] folded {len(delta.rem_src):,d} removals + "
         f"{len(delta.add_src):,d} adds and re-answered {len(post)} "
         f"queries in {dt:.2f}s (epoch {svc.epoch}, no executor built)")

    if args.skip_parity:
        show("[serve-graph] OK (parity skipped)")
        return

    # -- 4. post-fold answers vs a fresh full partition() -------------------
    g2 = svc.snapshot_graph()
    t0 = time.time()
    pg2 = partition(g2, args.workers, tau=svc.pg.tau, seed=args.seed,
                    layout="csr", balance="edges", device="cpu")
    t_full = time.time() - t0
    eng = Engine(cfg, device=device)
    rr = eng.run("sssp", pg2, source=int(pg2.perm[17]))
    want = rr.state.cpu().numpy().reshape(-1)[pg2.perm]
    if not np.allclose(post[0].value, want, equal_nan=True):
        raise RuntimeError("sssp diverged from the fresh-partition run "
                           "after the fold")
    pr = ppr_power(g2, 23, svc.ppr_alpha, args.ppr_iters)
    if not np.allclose(post[1].value, pr, atol=1e-5):
        raise RuntimeError("ppr diverged from the power iteration")
    roots = canonical_labels(pg2, eng.run("hashmin", pg2).state)
    host = components(g2.n, g2.src, g2.dst)
    if not np.array_equal(roots, host):
        raise RuntimeError("Hash-Min on the fresh partition diverged from "
                           "the host components")
    sizes = np.bincount(host, minlength=g2.n)
    if post[2].value != (int(host[5]), int(sizes[host[5]])):
        raise RuntimeError(f"ego {post[2].value} diverged from "
                           f"{(int(host[5]), int(sizes[host[5]]))}")
    show(f"[serve-graph] post-fold parity vs fresh partition() OK (full "
         f"re-partition takes {t_full:.2f}s)")
    show("[serve-graph] OK")


#: the process group's collective timeout, and how long the launcher
#: waits for its ranks
GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 3600


def _rank_main(rank: int, argv, init_method: str) -> None:
    """One rank: join the process group, run, leave."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    args = build_parser().parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=init_method,
        world_size=args.devices, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        run(args, rank=rank,
            device=torch.device("cuda", rank) if cuda else "cpu")
    finally:
        meshlib.destroy()


def main(argv=None):
    from repro_torch.graph.structs import resolve_device
    from repro_torch.launch.graph_run import rendezvous, spawn_ranks
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch
        if args.devices > torch.cuda.device_count():
            raise RuntimeError(
                f"--devices {args.devices} on cuda puts one GPU under each "
                f"rank; {torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory() as tmp:
        if args.devices == 1:
            _rank_main(0, argv, rendezvous(tmp))
        else:
            spawn_ranks(_rank_main, (argv, rendezvous(tmp)), args.devices,
                        JOIN_TIMEOUT_S)


if __name__ == "__main__":
    main()
