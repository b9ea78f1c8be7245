"""Graph-analytics launcher of the port — the paper-kind end-to-end workload.

    PYTHONPATH=src python -m repro_torch.launch.graph_run --algo hashmin \\
        --graph powerlaw --n 100000 --workers 32 --backend pallas --layout csr

Runs a full BSP computation on one device (``--device``, the GPU by
default) and reports the paper's metrics: total messages under each
channel mode, per-worker balance, supersteps, wall time.  The same flags
and output lines as ``repro.launch.graph_run`` for the single-device path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

GRAPH_NAMES = ("powerlaw", "road", "erdos")
ALGOS = ("hashmin", "pagerank", "sssp")


def make_graph(graph: str, n: int, seed: int):
    from repro_torch.graph import generators as gen
    if graph == "powerlaw":
        return gen.powerlaw(n, avg_deg=8, seed=seed)
    if graph == "road":
        return gen.grid_road(int(np.sqrt(n)), seed=seed, weighted=True)
    return gen.erdos(n, avg_deg=16, seed=seed)


def build(graph: str, n: int, seed: int, M: int, tau_arg: str,
          layout: str = "padded", balance: str = "hash",
          split_factor: float = 1.2, device="cuda"):
    from repro_torch.core.cost_model import choose_tau
    from repro_torch.graph.structs import partition
    g = make_graph(graph, n, seed).symmetrized()
    if tau_arg == "auto":
        tau = choose_tau(g.out_degrees(), M)
    elif tau_arg == "off":
        tau = None
    else:
        tau = int(tau_arg)
    pg = partition(g, M, tau=tau, seed=seed, layout=layout,
                   balance=balance, split_factor=split_factor,
                   device=device)
    return g, pg, tau


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", default="hashmin", choices=list(ALGOS))
    ap.add_argument("--graph", default="powerlaw", choices=list(GRAPH_NAMES))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--tau", default="auto")
    ap.add_argument("--no-mirroring", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="dense", choices=["dense", "pallas"],
                    help="combine-channel implementation: dense scatters or "
                         "the plan-driven segment_combine kernel path")
    ap.add_argument("--layout", default="padded", choices=["padded", "csr"],
                    help="edge representation: padded (M, E_loc) rows or "
                         "flat csr arrays + row offsets")
    ap.add_argument("--balance", default="hash",
                    choices=["hash", "edges", "edges+refine", "split",
                             "vertex-cut"],
                    help="vertex->worker placement: random hash, greedy "
                         "edge-count-balanced, edges + locality refinement, "
                         "edge-balanced + hot-worker splitting (csr only), "
                         "or edges + mega-hub vertex-cut")
    ap.add_argument("--split-factor", type=float, default=1.2,
                    help="split workers whose edge load exceeds this "
                         "multiple of the mean (balance=split)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.api import Engine
    from repro_torch.core.cost_model import straggler_report

    g, pg, tau = build(args.graph, args.n, args.seed, args.workers,
                       args.tau, layout=args.layout, balance=args.balance,
                       split_factor=args.split_factor, device=args.device)
    print(f"[graph] {args.graph}: n={g.n} m={g.m} M={args.workers} "
          f"tau={tau} max_deg={int(g.out_degrees().max())} "
          f"backend={args.backend} layout={args.layout} "
          f"balance={args.balance} device={pg.device}")

    mirror = not args.no_mirroring and tau is not None
    eng = Engine(backend=args.backend, layout=args.layout,
                 balance=args.balance, split_factor=args.split_factor,
                 use_mirroring=mirror, device=args.device)

    t0 = time.time()
    if args.algo == "sssp":
        gw = make_graph(args.graph, args.n, args.seed)
        if gw.weight is None:
            gw.weight = np.ones(gw.m, np.float32)
        pg = eng.partition(gw.symmetrized(), args.workers, tau=tau,
                           seed=args.seed)
        res = eng.run("sssp", pg, source=int(pg.perm[0]))
    else:
        params = {"n_iters": 30} if args.algo == "pagerank" else {}
        res = eng.run(args.algo, pg, **params)
    stats, n_ss = res.stats, res.n_supersteps
    dt = time.time() - t0

    rep = straggler_report(pg.edge_load(phys=True))
    print(f"[balance] {args.balance}: workers {pg.M} -> {pg.M_phys} "
          f"physical shards; edge-load max/mean="
          f"{rep['max_over_mean']:.2f} cv={rep['cv']:.2f}")
    print(f"[run] {args.algo}: {int(n_ss)} supersteps in {dt:.2f}s")
    for k in ("msgs_total", "msgs_combined", "msgs_mirror", "msgs_basic"):
        if k in stats:
            print(f"  {k:16s} {int(stats[k]):>14,d}")
    for k in ("per_worker_total", "per_worker_basic"):
        if k in stats:
            rep = straggler_report(np.asarray(stats[k]))
            print(f"  balance[{k}]: max/mean={rep['max_over_mean']:.2f} "
                  f"cv={rep['cv']:.2f} gini={rep['gini']:.3f}")


if __name__ == "__main__":
    main()
