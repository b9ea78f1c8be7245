"""Multi-process smoke of the hierarchical (host, device) mesh over
``torch.distributed`` (the counterpart of ``repro.launch.dist_smoke``).

Launches itself ``--hosts`` times as OS processes, one launcher a host
(the hidden ``--rank`` re-exec); launcher h starts ``--per-host`` rank
processes with global ranks ``h * per_host + t``.  This is the launch
path of a deployment on several machines: each rank meets the others
over TCP, every rank runs one sharded Hash-Min (``backend="pallas"``) on
the ``(hosts, per_host)`` mesh (``launch.mesh.graph_mesh``: rank h*T + t
is device t of host h) over ``partition(g, M, tau=8, seed=0,
layout="csr", hosts=hosts)``, and compares it with the same process's
single-device run: labels bitwise and every statistic integer-exact.
Each rank also prints the scalar ``segment_combine`` kernel launches of
its two runs (none on the CPU, where the kernel's plain version runs).

Rendezvous: the first launcher holds the master ``TCPStore`` on
``--master-addr`` (default 127.0.0.1) and ``--port``; every rank connects
to it as a client.  With ``--port 0`` (the default) the first launcher
binds a free port itself and hands the bound port to the other
launchers, so no port is picked and then raced.  The store lives until
every launcher has reported its ranks done.  ``--init-method`` (a
``file://`` or ``tcp://`` URL) replaces the store.

Devices: ``--device cuda`` (the default) runs NCCL with a card a rank
when the machine has a card for every rank of the world, else gloo with
rank t of a host on the host's card t (modulo its cards).  A launcher
asked for cuda that finds no card raises: there is no fallback to the
CPU, which ``--device cpu`` (gloo) asks for.

    PYTHONPATH=src python -m repro_torch.launch.dist_smoke \\
        --hosts 2 --per-host 2 --device cpu

Each rank prints its enumeration (world size, its host's ranks, its
device), its rendezvous seconds and ``parity OK`` or ``VIOLATED``; each
launcher its ranks' exit codes.  Exit codes: 0 = parity OK on every
rank, 1 = a failure (rendezvous, enumeration or parity), 124 = a
timeout.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

GROUP_TIMEOUT_S = 300
TIMEOUT = 124


def _say(msg: str) -> None:
    """One line in one write: the ranks share the launcher's stdout."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def _device(args, rank: int, t: int):
    """(backend, device) of global rank ``rank``, local index ``t``."""
    import torch
    if args.device == "cpu":
        return "gloo", torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("--device cuda: no CUDA device is visible")
    if count >= args.hosts * args.per_host:
        return "nccl", torch.device("cuda", rank)
    return "gloo", torch.device("cuda", t % count)


def _rank(t: int, h: int, args, port: int) -> None:
    """Global rank h*T + t: join the group, enumerate, run the parity
    check; exits with its code."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import Engine, config_of
    from repro_torch.graph import generators as gen
    from repro_torch.graph.structs import partition
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.launch import mesh as meshlib

    H, T = args.hosts, args.per_host
    rank, world = h * T + t, H * T
    backend, device = _device(args, rank, t)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    t0 = time.perf_counter()
    if args.init_method:
        dist.init_process_group(backend, init_method=args.init_method,
                                world_size=world, rank=rank, timeout=timeout)
    else:
        store = dist.TCPStore(args.master_addr, port, is_master=False,
                              timeout=timeout)
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank, timeout=timeout)
    rdv_s = time.perf_counter() - t0
    code = 1
    try:
        mine = meshlib.host_ranks(H, T)[h]
        _say(f"[dist_smoke] rank {rank}: world size "
             f"{dist.get_world_size()}, host {h} ranks {mine}, {backend} "
             f"on {device}; rendezvous {rdv_s:.3f} s")
        if dist.get_world_size() != world or dist.get_rank() != rank:
            _say(f"[dist_smoke] rank {rank}: enumeration wrong (want rank "
                 f"{rank} of {world})")
            return
        g = gen.powerlaw(args.n, avg_deg=5, seed=1, weighted=True
                         ).symmetrized()
        pg = partition(g, args.workers, tau=8, seed=0, layout="csr",
                       hosts=H, device=device)
        counter = kernel.segment_combine_blocks
        counter.launches = 0          # this rank's runs start here
        ref = Engine(config_of(pg, backend="pallas"),
                     device=device).run("hashmin", pg)
        t0 = time.perf_counter()
        res = Engine(config_of(pg, backend="pallas", devices=(H, T)),
                     device=device).run("hashmin", pg)
        run_s = time.perf_counter() - t0
        launches = counter.launches   # ... and end here (0 on the CPU)
        ok = (np.array_equal(res.state.cpu().numpy(),
                             ref.state.cpu().numpy())
              and res.n_supersteps == ref.n_supersteps
              and set(res.stats) == set(ref.stats)
              and all(np.array_equal(np.asarray(res.stats[k]),
                                     np.asarray(ref.stats[k]))
                      for k in ref.stats))
        _say(f"[dist_smoke] rank {rank}: hashmin n={args.n} M="
             f"{args.workers} on the ({H}, {T}) mesh, {res.n_supersteps} "
             f"supersteps in {run_s:.3f} s, {launches} scalar kernel "
             "launches: parity "
             + ("OK" if ok else "VIOLATED"))
        code = 0 if ok else 1
    finally:
        meshlib.destroy()
        sys.exit(code)


def _launcher(h: int, args) -> int:
    """Launcher of host ``h``: (host 0 over TCP) hold the master store,
    start the host's ranks, wait for them; returns the launcher's code."""
    import datetime as dt
    import multiprocessing as mp
    import torch.distributed as dist

    port, store = args.port, None
    if not args.init_method:
        timeout = dt.timedelta(seconds=GROUP_TIMEOUT_S)
        store = dist.TCPStore(args.master_addr, port, is_master=(h == 0),
                              timeout=timeout, wait_for_workers=False)
        if h == 0:
            port = store.port
            if args.port_file:   # hand the bound port to the others
                tmp = Path(args.port_file + ".tmp")
                tmp.write_text(str(port))
                os.replace(tmp, args.port_file)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(t, h, args, port))
             for t in range(args.per_host)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + args.timeout
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
            codes.append(TIMEOUT)
        else:
            codes.append(p.exitcode)
    _say(f"[dist_smoke] host {h}: rank exit codes {codes}")
    if store is not None:
        store.add("launchers_done", 1)
        if h == 0:   # keep the master store until every launcher is done
            while (int(store.add("launchers_done", 0)) < args.hosts
                   and time.monotonic() < deadline):
                time.sleep(0.05)
    if TIMEOUT in codes:
        return TIMEOUT
    return 0 if all(c == 0 for c in codes) else 1


def _wait_port(path: Path, proc, deadline: float) -> int:
    while time.monotonic() < deadline:
        if path.exists():
            return int(path.read_text())
        if proc.poll() is not None:
            raise RuntimeError(f"the first launcher exited ({proc.returncode})"
                               " before binding the store")
        time.sleep(0.05)
    raise TimeoutError("the first launcher did not bind the store in time")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--per-host", type=int, default=2)
    ap.add_argument("--master-addr", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="the master store's port; 0 binds a free one")
    ap.add_argument("--init-method", default="",
                    help="a rendezvous URL (file:// or tcp://) in place of "
                         "the launchers' store")
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="cuda (the default; raises when no card is "
                         "visible) or cpu")
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # internal: launcher re-exec
    ap.add_argument("--port-file", default="", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> None:
    import torch
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible")
    if args.rank is not None:
        sys.exit(_launcher(args.rank, args))

    def launch(h, port, extra=()):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dist_smoke",
             "--rank", str(h), "--hosts", str(args.hosts), "--per-host",
             str(args.per_host), "--master-addr", args.master_addr,
             "--port", str(port), "--n", str(args.n), "--workers",
             str(args.workers), "--device", args.device, "--timeout",
             str(args.timeout), *extra]
            + (["--init-method", args.init_method]
               if args.init_method else []), env=dict(os.environ))

    t0 = time.perf_counter()
    deadline = time.monotonic() + args.timeout
    with tempfile.TemporaryDirectory() as tmp:
        port = args.port
        if args.init_method:
            procs = [launch(h, port) for h in range(args.hosts)]
        else:
            port_file = Path(tmp) / "port"
            procs = [launch(0, port, ("--port-file", str(port_file)))]
            port = _wait_port(port_file, procs[0], deadline)
            procs += [launch(h, port) for h in range(1, args.hosts)]
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(
                    1.0, deadline - time.monotonic() + 30)))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                codes.append(TIMEOUT)
    where = (args.init_method or f"tcp store {args.master_addr}:{port}")
    _say(f"[dist_smoke] launcher exit codes: {codes} ({args.hosts} hosts x "
         f"{args.per_host} ranks over {where}; wall "
         f"{time.perf_counter() - t0:.3f} s)")
    if TIMEOUT in codes:
        sys.exit(TIMEOUT)
    sys.exit(0 if all(c == 0 for c in codes) else 1)


if __name__ == "__main__":
    main()
