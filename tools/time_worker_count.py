"""Time the per-worker tally on the card, and count the host syncs of a
Hash-Min and an S-V job.

    python3 tools/time_worker_count.py [--n 42850000] [--M 32] [--reps 20]
                                       [--syncs-only]

Run from the root of a source tree: ``repro_torch`` is imported from its
``src``.  ``--syncs-only`` skips part 1 (for a tree without the kernel).

1. The tally at the shape of the ``lj.hashmin`` cell's ``per_worker_basic``
   (``--n`` int64 edge owners sorted by worker, as csr edges arrive, and
   bool send flags): the worker_count kernel, its plain version
   (``index_add_``) and ``torch.bincount`` as the library yardstick (the
   bool path ``per_worker`` took before the kernel: a ``where`` to an int64
   copy, then ``bincount``).  Each time is one call between two CUDA
   events, the median of ``--reps`` after a warm-up; beside them the byte
   bound, ids and flags read once and the (M,) result written once, at
   3.35 TB/s.  Then the device time a call of the kernel and of
   ``bincount``, by kernel name, under torch.profiler (``--reps`` calls
   back to back): the one-call time also holds the wrapper's host time
   before the launch.
2. torch's sync debug mode ("warn") over one Hash-Min job on a 200k-vertex
   power-law graph and one S-V job on a 200k-vertex road lattice, M = 32,
   in the benchmark cells' engine configuration (pallas, csr, hash, tau
   from the cost model): the host syncs a job and a superstep, and the
   kernel's launches a superstep, and the lines of the program that
   synchronised (``where``: file:line, a count a job).

Prints one line a reading and, last, one JSON object of every reading.
Needs a CUDA card.
"""
import argparse
import collections
import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd() / "src"))

from repro_torch import tracing  # noqa: E402

HBM_BYTES_S = 3.35e12


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, reps: int) -> dict:
    """Device time a call of ``fn``, by kernel name, under torch.profiler:
    ``reps`` calls back to back after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key[:60]] = dev_us / 1e3 / reps
    return out


def tally_times(n: int, M: int, reps: int) -> dict:
    from repro_torch.kernels.worker_count import kernel as wk
    from repro_torch.kernels.worker_count.ref import worker_count_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ids = torch.sort(torch.randint(0, M, (n,), device=dev,
                                   generator=gen)).values
    flags = torch.rand(n, device=dev, generator=gen) < 0.5
    want = worker_count_ref(ids, flags, M)
    got = wk.worker_count(ids, flags, M)
    lib = torch.bincount(torch.where(flags, ids.long(), M),
                         minlength=M + 1)[:M]
    if not (torch.equal(got, want) and torch.equal(lib, want)):
        raise SystemExit("the kernel, the plain version and bincount differ")
    out = {"n": n, "M": M,
           "bound_ms": (n * (ids.element_size() + 1) + 8 * M)
           / HBM_BYTES_S * 1e3,
           "kernel_ms": time_ms(lambda: wk.launch(ids, flags, M), reps),
           "plain_ms": time_ms(lambda: worker_count_ref(ids, flags, M), reps),
           "bincount_ms": time_ms(lambda: torch.bincount(
               torch.where(flags, ids.long(), M), minlength=M + 1)[:M],
               reps)}
    out["kernel_device_ms"] = device_ms(lambda: wk.launch(ids, flags, M),
                                        reps)
    out["bincount_device_ms"] = device_ms(lambda: torch.bincount(
        torch.where(flags, ids.long(), M), minlength=M + 1)[:M], reps)
    for k, v in out.items():
        print(f"[tally] {k} {v}")
    return out


def count_syncs() -> dict:
    from repro_torch.api import Engine
    from repro_torch.core import cost_model
    from repro_torch.graph import generators as tgen
    out = {}
    for algo, g in [("hashmin", tgen.powerlaw(200_000, avg_deg=16,
                                             seed=1).symmetrized()),
                    ("sv", tgen.grid_road(448, seed=1))]:
        deg = np.bincount(g.src, minlength=g.n)
        eng = Engine(backend="pallas", layout="csr", balance="hash",
                     device="cuda")
        pg = eng.partition(g, 32, tau=cost_model.choose_tau(deg, 32), seed=0)
        eng.run(algo, pg)                        # builds plans and kernels
        torch.cuda.synchronize()
        before = tracing.counters().get("worker_count.launches", 0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = eng.run(algo, pg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = tracing.counters().get("worker_count.launches", 0) - before
        # torch's one-time notice that the mode is a prototype also says
        # "synchronizing"; it is no sync
        sync_warnings = [w for w in caught
                         if "synchronizing" in str(w.message)
                         and "prototype" not in str(w.message)]
        syncs = len(sync_warnings)
        where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                    for w in sync_warnings)
        out[algo] = {"supersteps": res.n_supersteps, "syncs_a_job": syncs,
                     "warnings": len(caught), "where": dict(where),
                     "syncs_a_superstep": syncs / res.n_supersteps,
                     "launches_a_superstep": launches / res.n_supersteps}
        print(f"[syncs] {algo} {out[algo]}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=42_850_000)
    ap.add_argument("--M", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--syncs-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(f"[card] {card[0] if card else torch.cuda.get_device_name(0)}")
    result = {"card": card[:1], "torch": torch.__version__,
              "tally": (None if args.syncs_only
                        else tally_times(args.n, args.M, args.reps)),
              "syncs": count_syncs()}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
