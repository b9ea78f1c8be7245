#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--n 4000000] [--workers 32] [--seed 0]

Phases; any failure exits non-zero and prints no result:

1. device: CUDA must be present; prints the card's name and power limit
   (nvidia-smi) and builds the segment_combine kernel from ``src/``.
2. kernel vs plain: random cases (sum/min/max x int32/float32 x several
   (eb, nb), -1 padding, values at the int32 bounds and +-inf) against the
   plain PyTorch version on the same inputs.  Integers and min/max must be
   bitwise equal; a float32 sum may differ by the summation order, at most
   2*eb*2^-24 times the slot's sum of |values| (twice the textbook bound
   on a recursive sum of eb terms).
3. main path at full size: a weighted, symmetrized ``powerlaw(n, avg_deg=8)``
   graph (n=4M: 62.5M directed edges, the scale of LiveJournal) is
   partitioned once (csr layout, hash balance, tau from the cost model, M
   workers) onto the card, and ``Engine(backend="pallas")`` runs Hash-Min,
   PageRank (30 iterations) and SSSP (from original vertex 0).  Each result
   is held against an oracle independent of the port (scipy's
   connected_components and dijkstra, a float64 power iteration) and
   against the port's own dense backend on the card; the kernel's launch
   counter must show 3 launches per Hash-Min superstep (Ch_msg values,
   Ch_msg hit counts, Ch_mir fan-out).
4. the kernel at the main path's shapes: its time, the plain version's,
   one PyTorch ``scatter_reduce`` computing the same function
   (``library_ms``, never called by the port) and the bound (bytes over
   3.35 TB/s).  One JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores
KERNEL_SOURCE = "src/repro_torch/csrc/segment_combine.cu"
KERNEL_REPLACES = "src/repro/kernels/segment_combine/kernel.py:60"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Per-phase wall seconds, printed as each phase ends."""

    def __init__(self):
        self.seconds = {}

    def run(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {self.seconds[name]:.3f} s")
        return out


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def build_kernel(kernel):
    info = kernel.build_library()
    log(f"[build] {info['path'].name}: built={info['built']} in "
        f"{info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[ptxas] {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2 / 4: kernel against its plain version, timings
# ---------------------------------------------------------------------------

def compare(torch, got, want, vals, idx, op, nb, ref_fn):
    """Max |got - want| (0 where both are equal, infinities included);
    fails unless ints and min/max are bitwise equal and a float32 sum is
    within the summation-order bound."""
    g = got.double()
    w = want.double()
    same = (g == w)
    err = float((g - w).abs().masked_fill(same, 0).max()) if g.numel() else 0.
    if op == "sum" and vals.dtype == torch.float32:
        abs_sum = ref_fn(vals.abs(), idx, "sum", nb).double()
        eb = vals.shape[1]
        bound = 2.0 * eb * 2.0 ** -24 * abs_sum
        bad = ~same & ((g - w).abs() > bound)
    else:
        bad = ~same
    if bool(bad.any()):
        i = int(bad.reshape(-1).nonzero()[0])
        fail(f"kernel != plain ({op}, {vals.dtype}, {tuple(vals.shape)}, "
             f"nb={nb}) at flat slot {i}: {g.reshape(-1)[i].item()} vs "
             f"{w.reshape(-1)[i].item()}")
    return err


def random_cases(torch, np, kernel, ref_fn, dev, seed):
    rng = np.random.RandomState(seed)
    info = np.iinfo(np.int32)
    max_err = 0.0
    n_cases = 0
    for op in ("sum", "min", "max"):
        for dtype in (torch.int32, torch.float32):
            for eb, nb in [(8, 32), (64, 128), (512, 32), (512, 128),
                           (37, 100), (1, 1)]:
                R = int(rng.randint(1, 4000))
                idx = rng.randint(-1, nb, (R, eb)).astype(np.int32)
                if dtype == torch.int32:
                    v = rng.randint(info.min, info.max, (R, eb),
                                    dtype=np.int64).astype(np.int32)
                    v.reshape(-1)[:3] = [info.min, info.max, -1][:v.size]
                else:
                    v = rng.randn(R, eb).astype(np.float32)
                    if op != "sum":
                        v.reshape(-1)[:2] = [np.inf, -np.inf][:v.size]
                vt = torch.from_numpy(v).to(dev)
                it = torch.from_numpy(idx).to(dev)
                got = kernel.segment_combine_blocks(vt, it, op, nb)
                torch.cuda.synchronize()
                want = ref_fn(vt, it, op, nb)
                max_err = max(max_err, compare(torch, got, want, vt, it, op,
                                               nb, ref_fn))
                n_cases += 1
    log(f"[kernel] {n_cases} random cases match the plain version "
        f"(max |err| {max_err:.3g})")
    return max_err


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_launch(torch, kernel, ref_fn, name, op, packed, idx, nb, iters):
    """Kernel, plain and library times of one launch, its bound, and the
    kernel's error against the plain version on these inputs."""
    R, eb = packed.shape
    item = packed.element_size()
    bytes_moved = R * eb * (item + 4) + R * nb * item
    got = kernel.segment_combine_blocks(packed, idx, op, nb)
    want = ref_fn(packed, idx, op, nb)
    torch.cuda.synchronize()
    err = compare(torch, got, want, packed, idx, op, nb, ref_fn)
    # the library yardstick: one scatter_reduce into a flat (R*nb,) buffer
    from repro_torch.kernels.segment_combine.ref import block_identity
    ident = block_identity(op, packed.dtype)
    hit = idx >= 0
    flat_idx = (torch.arange(R, device=packed.device)[:, None] * nb
                + torch.where(hit, idx, 0).long()).reshape(-1)
    flat_val = torch.where(hit, packed, ident).reshape(-1)
    base = torch.full((R * nb,), ident, dtype=packed.dtype,
                      device=packed.device)
    red = {"sum": "sum", "min": "amin", "max": "amax"}[op]
    lib_out = torch.scatter_reduce(base, 0, flat_idx, flat_val, red)
    compare(torch, lib_out.view(R, nb), want, packed, idx, op, nb, ref_fn)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = R * eb / FP32_OPS_PER_S
    row = {
        "launch": name, "op": op, "dtype": str(packed.dtype).split(".")[-1],
        "rows": R, "eb": eb, "nb": nb, "bytes": bytes_moved,
        "ms": cuda_ms(torch, lambda: kernel.segment_combine_blocks(
            packed, idx, op, nb), iters),
        "plain_ms": cuda_ms(torch, lambda: ref_fn(packed, idx, op, nb),
                            max(2, iters // 5)),
        "library_ms": cuda_ms(torch, lambda: torch.scatter_reduce(
            base, 0, flat_idx, flat_val, red), iters),
        # the least time: every byte once at the memory rate, or one
        # combine per lane at the float32 rate, whichever is larger
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "max_abs_err": err,
    }
    log(f"[kernel] {name}: {op} {row['dtype']} {R} x {eb} -> nb={nb}: "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} "
        f"ms ({bytes_moved / 1e9:.3f} GB)")
    return row


def main_path_launches(torch, planlib, kernel, ref_fn, pg, iters):
    """Time the kernel on the inputs one superstep of each algorithm hands
    it (superstep 0, every vertex active)."""
    dev = pg.device
    ids = pg.local_ids().to(torch.int32).reshape(-1)
    eg_src = pg.eg_src.long()
    E = eg_src.shape[0]
    imax = planlib.identity_of("min", torch.int32)
    # Hash-Min superstep: Ch_msg labels, Ch_msg hit counts, Ch_mir fan-out
    eg_lab = torch.where(pg.vmask.reshape(-1), ids, imax)[eg_src]
    hits = torch.ones(E, dtype=torch.int32, device=dev)
    safe = pg.mir_ids.long().clamp(0, pg.n_pad - 1)
    mir_lab = torch.where(pg.mir_ids < pg.n_pad, ids[safe], imax)
    fan = mir_lab[pg.mir_esrc.long()]
    # PageRank's float32 sum and SSSP's float32 min over the Ch_msg plan
    contrib = torch.rand(E, generator=torch.Generator(dev).manual_seed(0),
                         device=dev)
    dist = contrib + pg.eg_w
    rows = []
    for name, kind, op, vals in [
            ("hashmin/eg-values", "eg", "min", eg_lab),
            ("hashmin/eg-hits", "eg", "max", hits),
            ("hashmin/mir-fanout", "mir", "min", fan),
            ("pagerank/eg-values", "eg", "sum", contrib),
            ("sssp/eg-values", "eg", "min", dist)]:
        plan = planlib.get_plan(pg, kind)
        dp = planlib.device_plan(plan, dev)
        ident = 0 if op in ("sum", "max") else planlib.identity_of(
            op, vals.dtype)
        packed = torch.where(dp.row_valid, vals[dp.row_gather], ident)
        rows.append(time_launch(torch, kernel, ref_fn, name, op,
                                packed.contiguous(), dp.row_local, plan.nb,
                                iters))
        del packed
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path and its oracles
# ---------------------------------------------------------------------------

def oracles(np, g, source: int, n_iters: int, damping: float = 0.85):
    """Connected components, shortest distances and PageRank of ``g`` by
    scipy / float64 numpy, independent of the port."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    n = g.n
    A = sp.csr_matrix((g.weight.astype(np.float64), (g.src, g.dst)),
                      shape=(n, n))
    _, cc = csgraph.connected_components(A, directed=True,
                                         connection="weak")
    rep = np.full(cc.max() + 1, n, np.int64)
    np.minimum.at(rep, cc, np.arange(n))
    dist = csgraph.dijkstra(A, directed=True, indices=source)
    deg = np.bincount(g.src, minlength=n).astype(np.float64)
    P = sp.csr_matrix((np.ones(g.m), (g.dst, g.src)), shape=(n, n))
    x = np.full(n, 1.0 / n)
    for _ in range(n_iters):
        contrib = np.where(deg > 0, x / np.maximum(deg, 1), 0.0)
        x = (1 - damping) / n + damping * (P @ contrib)
    return rep[cc], dist, x


def assert_stats_equal(np, name, sa, sb):
    if set(sa) != set(sb):
        fail(f"{name}: stat keys differ: {sorted(sa)} vs {sorted(sb)}")
    for k in sa:
        if not np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])):
            fail(f"{name}: {k} differs between the pallas and dense "
                 f"backends: {sa[k]} vs {sb[k]}")


def timed(torch, fn):
    """(result, device ms, host s) of ``fn`` bracketed by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0


def profile_run(torch, fn, name: str, top: int = 12):
    """Where the device time of one run goes (torch.profiler): the busy
    share of the run's wall time and the operators with the most device
    time of their own."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels_us = sum(e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == cuda)
    if kernels_us <= 0:
        log(f"[profile] {name}: the profiler saw no device time "
            "(not measured)")
        return
    log(f"[profile] {name}: {res.n_supersteps} supersteps, wall "
        f"{wall_us / 1e3:.3f} ms (profiled), device busy "
        f"{kernels_us / 1e3:.3f} ms = {100 * kernels_us / wall_us:.1f}%")
    ops = [e for e in prof.key_averages() if e.device_type != cuda
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:top]:
        log(f"[profile] {name}:   {e.key:40s} calls={e.count:5d} "
            f"device={e.self_device_time_total / 1e3:9.3f} ms "
            f"({100 * e.self_device_time_total / kernels_us:5.1f}%)")


def main_path(torch, np, mods, args, dev, phases):
    api, structs, gen, cost_model, planlib, kernel = mods
    g = phases.run("graph", lambda: gen.powerlaw(
        args.n, avg_deg=8, seed=args.seed, weighted=True).symmetrized())
    M = args.workers
    tau = cost_model.choose_tau(g.out_degrees(), M)
    log(f"[graph] powerlaw n={g.n} m={g.m} M={M} tau={tau} max_deg="
        f"{int(g.out_degrees().max())} layout=csr balance=hash")
    eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                     device=dev)
    pg = phases.run("partition", eng.partition, g, M, tau=tau,
                    seed=args.seed)

    def plans():
        out = {}
        for kind in ("eg", "mir"):
            plan = planlib.get_plan(pg, kind)
            planlib.device_plan(plan, dev)
            out[kind] = plan
        torch.cuda.synchronize()
        return out
    plan = phases.run("plans", plans)
    for kind, p in plan.items():
        log(f"[plan] {kind}: {p.n_rows} rows x eb={p.eb}, nb={p.nb}, "
            f"{p.n_segs} segments")
    per_ss = 3 if plan["mir"].n_rows else 2

    source = int(pg.perm[0])
    runs = {}
    counter = kernel.segment_combine_blocks
    counter.launches = 0                      # the main path starts here
    for algo, params in [("hashmin", {}),
                         ("pagerank", {"n_iters": 30, "tol": 0.0}),
                         ("sssp", {"source": source})]:
        # the first run pays the caching allocator's growth; the second
        # is the steady state
        for tag in ("cold", "warm"):
            before = counter.launches
            res, dev_ms, host_s = phases.run(
                f"{algo}-{tag}", timed, torch,
                lambda: eng.run(algo, pg, **params))
            launches = counter.launches - before
            log(f"[run] {algo} ({tag}): {res.n_supersteps} supersteps, "
                f"{dev_ms:.3f} ms on the device clock "
                f"({dev_ms / res.n_supersteps:.3f} ms per superstep), "
                f"{host_s:.3f} s host; {launches} kernel launches; "
                f"msgs_total={res.stats['msgs_total']}")
            if launches != per_ss * res.n_supersteps:
                fail(f"{algo}: {launches} kernel launches in "
                     f"{res.n_supersteps} supersteps, expected {per_ss} per "
                     "superstep: the path did not go through the kernel")
        runs[algo] = (res, launches)
    main_launches = counter.launches          # ... and ends here
    if per_ss != 3:
        fail("no mirrored vertices at this size: Ch_mir did not run")

    # oracles independent of the port
    cc, dist_o, pr_o = phases.run("oracles", oracles, np, g, 0, 30)
    labels = structs.canonical_labels(pg, runs["hashmin"][0].state)
    if not np.array_equal(labels, cc):
        fail(f"Hash-Min components differ from scipy's in "
             f"{int((labels != cc).sum())} vertices")
    dist = runs["sssp"][0].state.reshape(-1).cpu().numpy()[pg.perm]
    fin = np.isfinite(dist_o)
    if not (np.array_equal(np.isfinite(dist), fin)
            and np.allclose(dist[fin], dist_o[fin], rtol=1e-5, atol=0)):
        fail("SSSP distances differ from scipy's dijkstra beyond rtol=1e-5")
    pr = runs["pagerank"][0].state.reshape(-1).cpu().numpy()[pg.perm]
    if not np.allclose(pr, pr_o, rtol=1e-4, atol=0):
        fail("PageRank differs from the float64 power iteration beyond "
             f"rtol=1e-4 (max rel {np.max(np.abs(pr - pr_o) / pr_o):.3g})")
    d_rel = np.abs(dist[fin] - dist_o[fin]) / np.maximum(dist_o[fin], 1e-30)
    log(f"[check] oracles: {len(np.unique(cc))} components equal scipy's; "
        f"SSSP max rel err {d_rel.max():.3g} over {int(fin.sum())} "
        f"reachable vertices; PageRank max rel err "
        f"{np.max(np.abs(pr - pr_o) / pr_o):.3g}")

    # the port's own dense backend on the card
    dense = api.Engine(backend="dense", layout="csr", balance="hash",
                       device=dev)

    def dense_checks():
        for algo, params in [("hashmin", {}),
                             ("pagerank", {"n_iters": 30, "tol": 0.0}),
                             ("sssp", {"source": source})]:
            res = dense.run(algo, pg, **params)
            ref = runs[algo][0]
            if res.n_supersteps != ref.n_supersteps:
                fail(f"{algo}: {res.n_supersteps} dense supersteps vs "
                     f"{ref.n_supersteps} pallas")
            assert_stats_equal(np, algo, res.stats, ref.stats)
            a, b = res.state.cpu().numpy(), ref.state.cpu().numpy()
            ok = (np.allclose(a, b, rtol=1e-5, atol=0) if algo == "pagerank"
                  else np.array_equal(a, b))
            if not ok:
                fail(f"{algo}: the pallas and dense backends disagree")
    phases.run("dense-parity", dense_checks)
    log("[check] pallas == dense on the card: Hash-Min labels and SSSP "
        "distances bitwise, PageRank rtol=1e-5, every msgs_*/per_worker_* "
        "equal")
    for algo, params in [("hashmin", {}),
                         ("pagerank", {"n_iters": 5, "tol": 0.0})]:
        phases.run(f"profile-{algo}", profile_run, torch,
                   lambda: eng.run(algo, pg, **params), algo)
    return pg, main_launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4_000_000,
                    help="vertices of the powerlaw graph")
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20,
                    help="launches per kernel timing")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs the port on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import api
    from repro_torch.core import cost_model
    from repro_torch.core import plan as planlib
    from repro_torch.graph import generators as gen
    from repro_torch.graph import structs
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.kernels.segment_combine.ref import (
        segment_combine_blocks_ref as ref_fn)

    phases = Phases()
    dev = torch.device("cuda")
    log(f"[device] {card_line()}")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{kind} x{count}")
    phases.run("build", build_kernel, kernel)
    rand_err = phases.run("kernel-vs-plain", random_cases, torch, np,
                          kernel, ref_fn, dev, args.seed)
    mods = (api, structs, gen, cost_model, planlib, kernel)
    pg, launches = main_path(torch, np, mods, args, dev, phases)
    rows = phases.run("kernel-timing", main_path_launches, torch, planlib,
                      kernel, ref_fn, pg, args.iters)
    import resource
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[device] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak host RSS "
        f"{host_gib:.2f} GiB; phases {json.dumps(phases.seconds)}")
    hm = [r for r in rows if r["launch"].startswith("hashmin/")]
    entry = {
        "name": "segment_combine_blocks", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max([rand_err] + [r["max_abs_err"] for r in rows]),
        # one Hash-Min superstep's three launches at the main path's shapes
        "ms": sum(r["ms"] for r in hm),
        "plain_ms": sum(r["plain_ms"] for r in hm),
        "bound_ms": sum(r["bound_ms"] for r in hm),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in hm)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in hm),
        "per_launch": rows,
    }
    log(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
