"""Graph-analytics launcher of the port — the paper-kind end-to-end workload.

    PYTHONPATH=src python -m repro_torch.launch.graph_run --algo hashmin \\
        --graph powerlaw --n 100000 --workers 32 --backend pallas --layout csr

Runs a full BSP computation on one device (``--device``, the GPU by
default) and reports the paper's metrics: total messages under each
channel mode, per-worker balance, supersteps, wall time.  The same flags
and output lines as ``repro.launch.graph_run``.

``--devices D`` runs the sharded executor on D ranks (the six algorithms
and GCN training), one process each
(``torch.multiprocessing``): on ``--device cuda`` an NCCL group with rank
r on ``cuda:r`` (D may not exceed the visible GPUs), on ``--device cpu`` a
gloo group.  Every rank builds the graph from ``--seed``; rank 0 prints.
``--hosts H`` arranges the D ranks as the (H, D/H) mesh (the partition is
host-affine, every routed exchange combines per level), ``--pipeline``
double-buffers the exchanges; the ``[balance]`` lines then give the
per-device edge load, ``[crossness]`` the static cross-worker, device and
host message fractions, and ``[exchange]`` the static wire lanes of a
superstep, within and across hosts.
"""
from __future__ import annotations

import argparse
import datetime
import tempfile
import time

import numpy as np

GRAPH_NAMES = ("powerlaw", "road", "erdos")
ALGOS = ("hashmin", "pagerank", "sv", "sssp", "msf", "attr_bcast", "gcn")


def make_graph(graph: str, n: int, seed: int):
    from repro_torch.graph import generators as gen
    if graph == "powerlaw":
        return gen.powerlaw(n, avg_deg=8, seed=seed)
    if graph == "road":
        return gen.grid_road(int(np.sqrt(n)), seed=seed, weighted=True)
    return gen.erdos(n, avg_deg=16, seed=seed)


def build(graph: str, n: int, seed: int, M: int, tau_arg: str,
          layout: str = "padded", balance: str = "hash",
          split_factor: float = 1.2, device="cuda", hosts=None):
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
                   hosts=hosts, device=device)
    return g, pg, tau


#: the process group's collective timeout, and how long the launcher
#: waits for its ranks
GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 3600


def rendezvous(tmp: str) -> str:
    """The process group's rendezvous for ranks on one host: a file
    store in the directory ``tmp`` (fresh and empty).  No TCP port is
    picked and then bound later, a window in which another process on
    the machine can take it."""
    return f"file://{tmp}/store"


def spawn_ranks(fn, args: tuple, nprocs: int, timeout_s: float) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and join
    them within ``timeout_s``; a rank that fails or hangs fails the
    launch, and every rank is stopped."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _rank_main(rank: int, argv, init_method: str) -> None:
    """One rank of ``--devices D``: join the process group, then run."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    args = parse_args(argv)
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


def parse_args(argv=None):
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
    ap.add_argument("--feat-dim", type=int, default=32,
                    help="gcn: embedding feature dimension F, the "
                         "vector-payload width every channel join carries "
                         "as a trailing (lanes, F) block")
    ap.add_argument("--hidden", type=int, default=64,
                    help="gcn: hidden width of the 2-layer GCN")
    ap.add_argument("--classes", type=int, default=8,
                    help="gcn: number of synthetic label classes")
    ap.add_argument("--epochs", type=int, default=10,
                    help="gcn: full-graph AdamW steps")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    ap.add_argument("--devices", type=int, default=None,
                    help="run the sharded executor on this many ranks, one "
                         "process each (NCCL on cuda:<rank>, gloo on cpu)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="arrange --devices D as the hierarchical (hosts, "
                         "D/hosts) mesh: the partition becomes host-affine, "
                         "every routed exchange combines or deduplicates "
                         "per level, and only the combined residue crosses "
                         "hosts")
    ap.add_argument("--pipeline", action="store_true",
                    help="double-buffer the sharded exchanges: chunk c's "
                         "all_to_all is in flight while chunk c-1 combines "
                         "(the results keep the parity contract)")
    args = ap.parse_args(argv)
    if args.hosts > 1 and (not args.devices or args.devices % args.hosts):
        ap.error(f"--hosts {args.hosts} needs --devices divisible by it")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.devices is None:
        run(args)
        return
    from repro_torch.graph.structs import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        import torch
        if args.devices > torch.cuda.device_count():
            raise RuntimeError(
                f"--devices {args.devices} on cuda puts one GPU under each "
                f"rank; {torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_rank_main, (argv, rendezvous(tmp)), args.devices,
                    JOIN_TIMEOUT_S)


def run(args, rank: int = 0, device=None):
    """The run itself, on ``device`` (default ``--device``); only rank 0
    prints."""
    from repro_torch.api import Engine
    from repro_torch.core.cost_model import straggler_report

    device = args.device if device is None else device
    show = print if rank == 0 else (lambda *a, **k: None)
    part_dev = "cpu" if args.devices is not None else device
    hosts = args.hosts if args.hosts > 1 else None
    # the engine's devices: None, D, or the (H, D/H) mesh
    dev = (hosts, args.devices // hosts) if hosts else args.devices
    dev_tag = f"{dev[0]}x{dev[1]}" if isinstance(dev, tuple) else str(dev)
    g, pg, tau = build(args.graph, args.n, args.seed, args.workers,
                       args.tau, layout=args.layout, balance=args.balance,
                       split_factor=args.split_factor, device=part_dev,
                       hosts=hosts)
    show(f"[graph] {args.graph}: n={g.n} m={g.m} M={args.workers} "
         f"tau={tau} max_deg={int(g.out_degrees().max())} "
         f"backend={args.backend} layout={args.layout} "
         f"balance={args.balance} device={device} devices={dev_tag} "
         f"pipeline={'on' if args.pipeline else 'off'}")

    mirror = not args.no_mirroring and tau is not None
    eng = Engine(backend=args.backend, layout=args.layout,
                 balance=args.balance, split_factor=args.split_factor,
                 hosts=hosts, use_mirroring=mirror, devices=dev,
                 pipeline=args.pipeline, device=device)

    t0 = time.time()
    if args.algo == "sssp":
        gw = make_graph(args.graph, args.n, args.seed)
        if gw.weight is None:
            gw.weight = np.ones(gw.m, np.float32)
        pg = eng.partition(gw.symmetrized(), args.workers, tau=tau,
                           seed=args.seed)
        res = eng.run("sssp", pg, source=int(pg.perm[0]))
    elif args.algo == "msf":
        gw = make_graph(args.graph, args.n, args.seed)
        if gw.weight is None:
            rng = np.random.RandomState(args.seed)
            gw.weight = rng.rand(gw.m).astype(np.float32) + 0.01
        pg = eng.partition(gw.symmetrized(), args.workers, tau=None,
                           seed=args.seed)
        res = eng.run("msf", pg)
        show(f"[msf] total weight {float(res.state[1]):.2f}, "
             f"{int(res.state[2])} edges, {res.jump_reads} host reads in "
             "its pointer jumping")
    elif args.algo == "gcn":
        from repro_torch.core.gspmm import gspmm_sharded, gspmm_stats
        from repro_torch.train.gcn import normalize_adjacency
        gw = normalize_adjacency(
            make_graph(args.graph, args.n, args.seed).symmetrized())
        pg = eng.partition(gw, args.workers, tau=tau, seed=args.seed)
        res = eng.run("gcn", pg, feat_dim=args.feat_dim,
                      hidden=args.hidden, n_classes=args.classes,
                      epochs=args.epochs, seed=args.seed)
        losses = res.history
        show(f"[gcn] F={args.feat_dim} hidden={args.hidden} "
             f"classes={args.classes}: loss "
             f"{losses[0]:.4f} -> {losses[-1]:.4f} over "
             f"{args.epochs} epochs")
        # message accounting for ONE aggregation join (the training step
        # runs 4 per epoch: 2 forward + 2 backward-cotangent joins)
        if dev:
            _, res.stats = gspmm_sharded(
                pg, "u_mul_e_sum", res.state["emb"], devices=dev,
                backend=args.backend, pipeline=args.pipeline,
                use_mirroring=mirror, device=device)
        else:
            _, res.stats = gspmm_stats(pg, "u_mul_e_sum", res.state["emb"],
                                       backend=args.backend,
                                       use_mirroring=mirror)
    elif args.algo == "attr_bcast":
        import torch
        attr = 3 * torch.arange(pg.n_pad, dtype=torch.float32,
                                device=pg.device).view(pg.M, pg.n_loc)
        res = eng.run("attr_bcast", pg, attr=attr)
        res.n_supersteps = 2    # request + respond rounds
    else:
        params = {"n_iters": 30} if args.algo == "pagerank" else {}
        res = eng.run(args.algo, pg, **params)
    stats, n_ss = res.stats, res.n_supersteps
    dt = time.time() - t0

    if rank == 0:
        report_balance(args, pg, dev, dev_tag)
    show(f"[run] {args.algo}: {int(n_ss)} supersteps in {dt:.2f}s")
    for k in ("msgs_total", "msgs_combined", "msgs_mirror", "msgs_basic",
              "msgs_rr"):
        if k in stats:
            show(f"  {k:16s} {int(stats[k]):>14,d}")
    for k in ("per_worker_total", "per_worker_rr", "per_worker_basic"):
        if k in stats:
            rep = straggler_report(np.asarray(stats[k]))
            show(f"  balance[{k}]: max/mean={rep['max_over_mean']:.2f} "
                 f"cv={rep['cv']:.2f} gini={rep['gini']:.3f}")
    if dev and rank == 0:
        report_exchange(pg, dev, dev_tag, args.backend, mirror, device)


def report_balance(args, pg, dev, dev_tag) -> None:
    """The ``[balance]`` and ``[crossness]`` lines of the partition the
    algorithm ran on (SSSP and MSF build a weighted one)."""
    from repro_torch.core import exec as exec_mod
    from repro_torch.core.cost_model import straggler_report
    rep = straggler_report(pg.edge_load(phys=True))
    print(f"[balance] {args.balance}: workers {pg.M} -> {pg.M_phys} "
          f"physical shards; edge-load max/mean="
          f"{rep['max_over_mean']:.2f} cv={rep['cv']:.2f}")
    if dev and pg.layout == "csr":
        dl = straggler_report(exec_mod.device_edge_loads(pg, dev))
        print(f"[balance] device edge-load max/mean="
              f"{dl['max_over_mean']:.2f} over {dev_tag} devices")
    cr = exec_mod.crossness_report(pg, dev)
    line = (f"[crossness] cross-worker message fraction="
            f"{cr['cross_worker_frac']:.3f}")
    if "cross_device_frac" in cr:
        line += f" cross-device={cr['cross_device_frac']:.3f}"
    if "cross_host_frac" in cr:
        line += f" cross-host={cr['cross_host_frac']:.3f}"
    print(line)


def report_exchange(pg, dev, dev_tag, backend: str, mirror: bool,
                    device) -> None:
    """The ``[exchange]`` lines: the static wire lanes of a superstep's
    plan exchanges and fetch plans at ``device``'s block width, within and
    across hosts (on the 2-D mesh ``cross_host`` is the post-combine
    residue)."""
    from repro_torch.core import exec as exec_mod
    from repro_torch.core.plan import default_nb
    vol = exec_mod.exchange_volume_report(
        pg, dev, plan_kinds=exec_mod.broadcast_plan_kinds(backend, mirror),
        nb=default_nb(device))
    print(f"[exchange] devices={dev_tag}: wire lanes/superstep "
          f"total={vol['total']:,d} intra_host={vol['intra_host']:,d} "
          f"cross_host={vol['cross_host']:,d}")
    for name, e in sorted(vol["per_exchange"].items()):
        print(f"  {name:16s} intra={e['intra_host']:>12,d} "
              f"cross={e['cross_host']:>12,d}")


if __name__ == "__main__":
    main()
