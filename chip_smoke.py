#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--n 4000000] [--workers 32] [--seed 0]

Phases; any failure exits non-zero and prints no result:

1. device: CUDA must be present; prints the card's name and power limit
   (nvidia-smi) and builds both segment_combine kernels (one source) from
   ``src/``.
2. kernels vs plain: random cases (sum/min/max x int32/float32 x several
   (eb, nb), for the vector kernel x F in {1, 3, 32, 64, 130}; -1 padding,
   values at the int32 bounds and +-inf) against the plain PyTorch version
   on the same inputs.  Integers and min/max must be bitwise equal; a
   float32 sum may differ by the summation order, at most 2*eb*2^-24 times
   the slot's sum of |values| (twice the textbook bound on a recursive sum
   of eb terms).  F=1 through the vector kernel must equal the scalar
   kernel bitwise.
3. the algorithms at full size: a weighted, symmetrized
   ``powerlaw(n, avg_deg=8)`` graph (n=4M: 62.5M directed edges, the scale
   of LiveJournal) with the GCN's normalized weights (``normalize_adjacency``,
   so one partition serves both paths) is partitioned once (csr layout,
   hash balance, tau from the cost model, M workers) onto the card, and
   ``Engine(backend="pallas")`` runs Hash-Min, PageRank (30 iterations) and
   SSSP (from original vertex 0).  Each result is held against an oracle
   independent of the port (scipy's connected_components and dijkstra on
   the same weights, a float64 power iteration) and against the port's own
   dense backend on the card; the scalar kernel's launch counter must show
   3 launches per Hash-Min superstep (Ch_msg values, Ch_msg hit counts,
   Ch_mir fan-out).
4. GCN training at full width on that graph: ``Engine.run("gcn")`` with
   F=32, hidden=64, 8 classes, lr=1e-2, 4 epochs.  The vector kernel's
   launch count must equal what the plan chunks predict (2 joins at F=32
   and 2 at F=64 an epoch) and the loss must fall; the first layer's join
   and its gradient are held against scipy's float64 ``A_hat^T X`` and
   ``A_hat G`` within (deg+3)*2^-24 of ``|A_hat|^T |X|`` (the
   summation-order bound of deg products); the assembled step (every
   leaf's gradient, and its change after one epoch of clip + AdamW) is
   held against a float64 scipy/numpy step that takes the card's relu
   (every flip must lie within round-off of 0): gradients within 1e-4 of
   their norm, the change within 1e-3.  A
   replay of the run records every join's input for phase 6; one join with
   and without the message accounting is timed; device ms an epoch, a
   profile of one epoch and the peak device memory are printed.
5. pallas == dense at n=200k on the card: the three gSpMM kinds (max
   bitwise, sums within 1e-5 of ``|A_hat|^T |X|``, every ``msgs_*`` and
   ``per_worker_*`` equal) and a 3-epoch GCN loss history (within 1e-6;
   it must fall by more than 1e-4).
6. the kernels at the main paths' shapes: their time, the plain version's,
   one PyTorch call computing the same function (``library_ms``, never
   called by the port: ``scatter_reduce`` for the scalar kernel,
   ``torch.zeros`` + ``index_add_`` for the vector kernel) and the bound
   (bytes over 3.35 TB/s), each timed on every launch of its counted run
   (the scalar kernel in a replay of the algorithm runs, the vector kernel
   on the recorded join inputs), so that its times and launches cover the
   same runs.  One JSON line ``{"kernels": [...]}``, then the last line
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
VEC_KERNEL_REPLACES = "src/repro/kernels/segment_combine/kernel.py:84"
GCN = {"feat_dim": 32, "hidden": 64, "n_classes": 8, "lr": 1e-2}
GCN_EPOCHS = 4
GCN_CLIP, ADAM_EPS = 1.0, 1e-8     # the GCN step's clip norm, AdamW's eps
PARITY_N = 200_000
U32 = 2.0 ** -24                   # float32 unit roundoff
# a float32 loss is a mean of n float32 terms, each within a few ulps
LOSS_RTOL = 1e-5
# with the card's own relu derivative, a float32 gradient differs from
# float64 by summation order only, ~1e-6 of its norm; a wrong or missing
# term moves it by O(1)
GRAD_RTOL = 1e-4
# one epoch of Engine.run evaluates the forward again: the merge's atomic
# adds reorder its float32 sums, so a few pre-activations within round-off
# of 0 may take the other side of the relu, each moving the step by about
# 1e-4 of its norm
STEP_RTOL = 1e-3


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


def random_vec_cases(torch, np, kernel, ref_fn, dev, seed):
    """The vector kernel against the plain version, and F=1 against the
    scalar kernel."""
    rng = np.random.RandomState(seed + 1)
    info = np.iinfo(np.int32)
    max_err = 0.0
    n_cases = 0
    for op in ("sum", "min", "max"):
        for dtype in (torch.int32, torch.float32):
            for eb, nb in [(8, 32), (64, 128), (512, 128), (37, 100),
                           (64, 1024)]:
                for F in (1, 3, 32, 64, 130):
                    R = int(rng.randint(1, max(2, 2 ** 22 // (eb * F))))
                    R = min(R, 2000)
                    idx = rng.randint(-1, nb, (R, eb)).astype(np.int32)
                    if dtype == torch.int32:
                        v = rng.randint(info.min, info.max, (R, eb, F),
                                        dtype=np.int64).astype(np.int32)
                        v.reshape(-1)[:3] = [info.min, info.max, -1][:v.size]
                    else:
                        v = rng.randn(R, eb, F).astype(np.float32)
                        if op != "sum":
                            v.reshape(-1)[:2] = [np.inf, -np.inf][:v.size]
                    vt = torch.from_numpy(v).to(dev)
                    it = torch.from_numpy(idx).to(dev)
                    got = kernel.segment_combine_blocks(vt, it, op, nb)
                    torch.cuda.synchronize()
                    want = ref_fn(vt, it, op, nb)
                    max_err = max(max_err, compare(torch, got, want, vt, it,
                                                   op, nb, ref_fn))
                    if F == 1:
                        scalar = kernel.launch(vt[:, :, 0].contiguous(), it,
                                               op, nb)
                        torch.cuda.synchronize()
                        if not torch.equal(scalar, got[:, :, 0]):
                            fail(f"vector kernel at F=1 != scalar kernel "
                                 f"({op}, {dtype}, eb={eb}, nb={nb})")
                    n_cases += 1
    log(f"[kernel] {n_cases} random vector cases match the plain version "
        f"(max |err| {max_err:.3g}); F=1 equals the scalar kernel bitwise")
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


def add_launch(torch, row, fns, outs_cmp, ref_fn):
    """Time one launch's calls once each (CUDA events) into ``row`` and
    hold the kernel and the library call against the plain version."""
    outs = {}
    for key, fn in fns.items():
        outs[key], ms = event_ms(torch, fn)
        row[key] += ms
    row["launches"] += 1
    packed, idx, op, nb, shape = outs_cmp
    row["max_abs_err"] = max(row["max_abs_err"], compare(
        torch, outs["ms"], outs["plain_ms"], packed, idx, op, nb, ref_fn))
    compare(torch, outs["library_ms"].view(shape), outs["plain_ms"], packed,
            idx, op, nb, ref_fn)
    return outs["ms"]


def finish_rows(rows, bytes_of, ops_of):
    """Each row's bound over all its launches: the larger of its least
    bytes (``bytes_of``) at the memory rate and its operations
    (``ops_of``) at the float32 rate."""
    for row in rows:
        row["bytes"] = bytes_of(row)
        t_bytes = row["bytes"] / HBM_BYTES_PER_S
        t_ops = ops_of(row) / FP32_OPS_PER_S
        row["bound_ms"] = max(t_bytes, t_ops) * 1e3
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def algo_launches(torch, kernel, ref_fn, eng, pg, algos, kinds):
    """Time the scalar kernel on every launch of the counted algorithm
    runs: a replay runs each algorithm twice, as counted, with
    ``kernel.launch`` wrapped so that each launch, on the inputs the path
    hands it, is timed once (kernel, plain version, and one
    ``torch.full`` + ``scatter_reduce_`` into a flat (rows*nb,) buffer,
    which writes the output once) and held against the plain version.
    Returns one row per (algorithm, plan, op)."""
    from repro_torch.kernels.segment_combine.ref import block_identity
    acc = {}
    launch = kernel.launch
    algo_now = []

    def timed_launch(vals, idx, op, nb):
        R, eb = vals.shape
        dtype = str(vals.dtype).split(".")[-1]
        name = f"{algo_now[-1]}/{kinds[(R, eb)]}-{op}"
        row = acc.get(name)
        ident = block_identity(op, vals.dtype)
        hit = idx >= 0
        flat_idx = (torch.arange(R, device=vals.device)[:, None] * nb
                    + torch.where(hit, idx, 0).long()).reshape(-1)
        flat_val = torch.where(hit, vals, ident).reshape(-1)
        red = {"sum": "sum", "min": "amin", "max": "amax"}[op]
        fns = {"ms": lambda: launch(vals, idx, op, nb),
               "plain_ms": lambda: ref_fn(vals, idx, op, nb),
               "library_ms": lambda: torch.full(
                   (R * nb,), ident, dtype=vals.dtype,
                   device=vals.device).scatter_reduce_(
                       0, flat_idx, flat_val, red)}
        if row is None:                           # warm-up, not timed
            row = acc[name] = {
                "launch": name, "op": op, "dtype": dtype, "rows": R,
                "eb": eb, "nb": nb, "item": vals.element_size(),
                "launches": 0, "ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "max_abs_err": 0.0}
            for fn in fns.values():
                fn()
        return add_launch(torch, row, fns, (vals, idx, op, nb, (R, nb)),
                          ref_fn)
    kernel.launch = timed_launch
    try:
        for algo, params in algos:
            algo_now.append(algo)
            for _ in ("cold", "warm"):
                eng.run(algo, pg, **params)
    finally:
        kernel.launch = launch
    rows = list(acc.values())
    # a launch reads every lane and index once and writes its output once
    finish_rows(rows, lambda r: r["launches"] * r["rows"] * (
                    r["eb"] * (r["item"] + 4) + r["nb"] * r["item"]),
                lambda r: r["launches"] * r["rows"] * r["eb"])
    for r in rows:
        n = r["launches"]
        log(f"[kernel] {r['launch']}: {r['op']} {r['dtype']} {r['rows']} x "
            f"{r['eb']} -> nb={r['nb']}, {n} launches: kernel "
            f"{r['ms']:.4f} ms ({r['ms'] / n:.4f} each), plain "
            f"{r['plain_ms']:.4f} ({r['plain_ms'] / n:.4f}), library "
            f"{r['library_ms']:.4f} ({r['library_ms'] / n:.4f}), bound "
            f"{r['bound_ms']:.4f} ({r['bound_ms'] / n:.4f}) ms")
    return rows


def event_ms(torch, fn):
    """(result, device ms) of one call of ``fn`` between two CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def join_inputs(torch, eng, pg, params0):
    """The input of every gSpMM join of a replay of the counted GCN run
    (same params, same epochs), in call order: per epoch the two forward
    joins' features and the two backward joins' cotangents.  Recorded by
    wrapping ``channels.broadcast``, through which every join runs."""
    from repro_torch.core import channels
    seen = []
    broadcast = channels.broadcast

    def record(g, vals, *a, **kw):
        seen.append(vals.detach().clone())
        return broadcast(g, vals, *a, **kw)
    channels.broadcast = record
    try:
        eng.run("gcn", pg, epochs=GCN_EPOCHS, params=params0, **GCN)
    finally:
        channels.broadcast = broadcast
    if len(seen) != 4 * GCN_EPOCHS:
        fail(f"gcn replay: {len(seen)} joins in {GCN_EPOCHS} epochs, "
             "expected 4 an epoch")
    return seen


def gcn_launches(torch, planlib, kernel, ref_fn, pg, inputs):
    """Time the vector kernel on every launch of the counted GCN run: for
    each join input of its replay (``join_inputs``) and each of the Ch_msg
    and mirror plans, every row chunk, its lanes composed as the join
    composes them (a source gather times the normalized weight).  Each
    chunk is timed once (kernel, plain version, and one ``torch.zeros`` +
    ``index_add_`` on the (rows*nb, F) view, which writes the output once)
    and held against the plain version.  Returns one row per (plan, F),
    summed over its joins."""
    dev = pg.device
    safe = pg.mir_ids.long().clamp(0, pg.n_pad - 1)
    valid = (pg.mir_ids < pg.n_pad).reshape(-1)
    acc = {}
    for x in inputs:
        F = x.shape[-1]
        flat = x.reshape(-1, F)
        maps = {"eg": (flat, pg.eg_src.long(), pg.eg_w),
                "mir": (torch.where(valid[:, None], flat[safe], 0.0),
                        pg.mir_esrc.long().reshape(-1),
                        pg.mir_ew.reshape(-1))}
        for kind, (src, index, w) in maps.items():
            plan = planlib.get_plan(pg, kind)
            dp = planlib.device_plan(plan, dev)
            step = planlib.vec_chunk_rows(plan, F)
            nb, eb = plan.nb, plan.eb
            first = (kind, F) not in acc
            row = acc.setdefault((kind, F), {
                "launch": f"gcn/{kind}-F{F}", "op": "sum",
                "dtype": "float32", "rows": plan.n_rows, "eb": eb, "nb": nb,
                "F": F, "chunk_rows": step, "joins": 0, "launches": 0,
                "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "max_abs_err": 0.0})
            for r0 in range(0, plan.n_rows, step):
                sl = slice(r0, r0 + step)
                lanes = dp.row_gather[sl]
                packed = torch.where(dp.row_valid[sl][..., None],
                                     src[index[lanes]] * w[lanes][..., None],
                                     0.0).contiguous()
                idx = dp.row_local[sl]
                R = packed.shape[0]
                hit = idx >= 0
                flat_idx = (torch.arange(R, device=dev)[:, None] * nb
                            + torch.where(hit, idx, 0).long()).reshape(-1)
                flat_val = torch.where(hit[..., None], packed, 0.0
                                       ).reshape(-1, F)
                fns = {"ms": lambda: kernel.segment_combine_blocks(
                           packed, idx, "sum", nb),
                       "plain_ms": lambda: ref_fn(packed, idx, "sum", nb),
                       "library_ms": lambda: torch.zeros(
                           (R * nb, F), device=dev).index_add_(
                               0, flat_idx, flat_val)}
                if first and r0 == 0:             # warm-up, not timed
                    for fn in fns.values():
                        fn()
                add_launch(torch, row, fns,
                           (packed, idx, "sum", nb, (R, nb, F)), ref_fn)
                del packed, flat_val
            row["joins"] += 1
    rows = list(acc.values())
    # a join reads every lane and index once and writes the dense
    # (rows, nb, F) output once
    finish_rows(rows, lambda r: r["joins"] * r["rows"] * (
                    r["eb"] * (4 * r["F"] + 4) + r["nb"] * 4 * r["F"]),
                lambda r: r["joins"] * r["rows"] * r["eb"] * r["F"])
    for row in rows:
        R, eb, nb, F = row["rows"], row["eb"], row["nb"], row["F"]
        j = row["joins"]
        log(f"[kernel] {row['launch']}: sum float32 {R} x {eb} x {F} -> "
            f"nb={nb}, {j} joins in {row['launches']} launches: kernel "
            f"{row['ms']:.4f} ms ({row['ms'] / j:.4f} a join), plain "
            f"{row['plain_ms']:.4f} ({row['plain_ms'] / j:.4f}), library "
            f"{row['library_ms']:.4f} ({row['library_ms'] / j:.4f}), bound "
            f"{row['bound_ms']:.4f} ({row['bound_ms'] / j:.4f}) ms "
            f"({row['bytes'] / 1e9:.3f} GB)")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path and its oracles
# ---------------------------------------------------------------------------

def adjacency(np, g):
    """scipy's float64 (n, n) adjacency: A[u, v] = w(u, v)."""
    import scipy.sparse as sp
    return sp.csr_matrix((g.weight.astype(np.float64), (g.src, g.dst)),
                         shape=(g.n, g.n))


def oracles(np, g, A, source: int, n_iters: int, damping: float = 0.85):
    """Connected components, shortest distances and PageRank of ``g`` by
    scipy / float64 numpy, independent of the port."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    n = g.n
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
    """Stats as ``Engine.run`` returns them (host numbers) or as a channel
    join returns them (tensors on the card): equal, integer for integer."""
    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
    if set(sa) != set(sb):
        fail(f"{name}: stat keys differ: {sorted(sa)} vs {sorted(sb)}")
    for k in sa:
        if not np.array_equal(host(sa[k]), host(sb[k])):
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


def profile_run(torch, fn, name: str, top: int = 12,
                unit: str = "supersteps"):
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
    log(f"[profile] {name}: {res.n_supersteps} {unit}, wall "
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
    from repro_torch.train.gcn import normalize_adjacency
    g = phases.run("graph", lambda: normalize_adjacency(gen.powerlaw(
        args.n, avg_deg=8, seed=args.seed, weighted=True).symmetrized()))
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

    algos = [("hashmin", {}), ("pagerank", {"n_iters": 30, "tol": 0.0}),
             ("sssp", {"source": int(pg.perm[0])})]
    runs = {}
    counter = kernel.segment_combine_blocks
    counter.launches = counter.launches_vec = 0   # the path starts here
    for algo, params in algos:
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
    if counter.launches_vec:
        fail(f"{counter.launches_vec} vector kernel launches on a scalar path")
    if per_ss != 3:
        fail("no mirrored vertices at this size: Ch_mir did not run")

    # oracles independent of the port
    A = phases.run("adjacency", adjacency, np, g)
    cc, dist_o, pr_o = phases.run("oracles", oracles, np, g, A, 0, 30)
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
        for algo, params in algos:
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
    return g, A, pg, main_launches, algos


# ---------------------------------------------------------------------------
# phase 4: GCN training at full width, and its oracles
# ---------------------------------------------------------------------------

def within_sum_bound(np, name, got, want, mag, deg, factor=None):
    """Fail unless |got - want| <= factor * |A|^T|X| per entry; ``factor``
    defaults to the summation bound (deg+3)*2^-24 of each row.  Returns the
    largest |err| / |A|^T|X| seen."""
    err = np.abs(got - want)
    lim = (factor if factor is not None else (deg[:, None] + 3.0) * U32) * mag
    bad = err > lim
    if bad.any():
        i = np.argwhere(bad)[0]
        fail(f"{name}: {got[tuple(i)]} vs {want[tuple(i)]} at {tuple(i)}, "
             f"beyond {lim[tuple(i)]:.3g}")
    return float(np.max(err / np.maximum(mag, 1e-30)))


def gcn_path(torch, np, args, dev, phases, g, A, pg):
    """The GCN slice's main path on the algorithms' partition."""
    from repro_torch import api
    from repro_torch.core import gspmm
    from repro_torch.core import plan as planlib
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.train.gcn import init_gcn_params

    widths = (GCN["feat_dim"], GCN["hidden"])
    chunks = {(k, F): planlib.vec_chunks(planlib.get_plan(pg, k), F)
              for k in ("eg", "mir") for F in widths}
    per_epoch = 2 * sum(chunks.values())      # forward + backward joins
    log(f"[gcn] vector chunks a join: {chunks}; {per_epoch} launches an "
        "epoch expected")
    eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                     device=dev)
    counter = kernel.segment_combine_blocks
    # the random init (numpy, 128M normals at n=4M) is host set-up: made
    # before the clock starts and handed to the run
    dims = {k: GCN[k] for k in ("feat_dim", "hidden", "n_classes")}
    params0 = phases.run("gcn-init", init_gcn_params, pg, **dims)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.launches = counter.launches_vec = 0   # the path starts here
    res, dev_ms, host_s = phases.run(
        "gcn", timed, torch, lambda: eng.run(
            "gcn", pg, epochs=GCN_EPOCHS, params=params0, **GCN))
    scalar, vec = counter.launches, counter.launches_vec  # ... ends here
    peak = torch.cuda.max_memory_allocated()
    losses = res.history
    log(f"[run] gcn: {GCN_EPOCHS} epochs, {dev_ms:.3f} ms on the device "
        f"clock ({dev_ms / GCN_EPOCHS:.3f} ms an epoch), {host_s:.3f} s "
        f"host; {vec} vector and {scalar} scalar kernel launches; peak "
        f"device memory {peak / 2**30:.2f} GiB; loss "
        f"{' -> '.join(f'{x:.5f}' for x in losses)}")
    if vec != per_epoch * GCN_EPOCHS:
        fail(f"gcn: {vec} vector kernel launches in {GCN_EPOCHS} epochs, "
             f"expected {per_epoch} an epoch: the path did not go through "
             "the kernel")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"gcn: the loss did not fall: {losses}")
    for k, v in res.state.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"gcn: non-finite values in the trained {k}")
    inputs = phases.run("gcn-replay", join_inputs, torch, eng, pg, params0)
    phases.run("gcn-stats-cost", stats_cost, torch, np, gspmm, pg, dev)

    # the first layer's join and its gradient against scipy in float64
    def join_and_grad():
        x = params0["emb"].clone().requires_grad_(True)
        out = gspmm.gspmm_join(pg, "u_mul_e_sum", backend="pallas")(x)
        cot = torch.randn(out.shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
        (grad,) = torch.autograd.grad(torch.sum(out * cot), [x])
        torch.cuda.synchronize()
        host = [t.detach().reshape(pg.n_pad, -1).cpu().numpy()[pg.perm]
                .astype(np.float64) for t in (x, out, cot, grad)]
        return host
    x, out, cot, grad = phases.run("gcn-join", join_and_grad)

    def check():
        # products summed into each row: its in-edges (A^T X), out-edges (A G)
        deg_in = np.bincount(g.dst, minlength=g.n).astype(np.float64)
        deg_out = np.bincount(g.src, minlength=g.n).astype(np.float64)
        At = A.T.tocsr()
        z1 = At @ x
        mag = At @ np.abs(x)
        e1 = within_sum_bound(np, "u_mul_e_sum(emb) vs scipy A^T X", out,
                              z1, mag, deg_in)
        # the summation-order bound of the float32 join, per entry
        z1_err = (deg_in[:, None] + 3.0) * U32 * mag
        e2 = within_sum_bound(np, "join gradient vs scipy A G", grad,
                              A @ cot, A @ np.abs(cot), deg_out)
        return e1, e2, At, z1, z1_err
    e1, e2, At, z1, z1_err = phases.run("gcn-oracles", check)
    log(f"[check] gcn: u_mul_e_sum(emb) vs scipy A_hat^T X max "
        f"|err|/(|A|^T|X|) {e1:.3g}; gradient vs scipy A_hat G {e2:.3g} "
        "(bound (deg+3)*2^-24 per row)")
    phases.run("gcn-step-oracle", check_step, torch, np, eng, pg, params0,
               A, At, z1, z1_err, res.history[0])
    del At, z1, z1_err, x, out, cot, grad
    phases.run("profile-gcn", profile_run, torch,
               lambda: eng.run("gcn", pg, epochs=1, params=res.state, **GCN),
               "gcn", unit="epochs")
    return vec, peak, inputs


def stats_cost(torch, np, gspmm, pg, dev, reps: int = 3):
    """Device ms of one u_mul_e_sum join at each GCN width without the
    message accounting (the training join, ``gspmm_join``) and with it
    (``gspmm_stats``), alternated ``reps`` times after a warm-up of each:
    what skipping the accounting saves an epoch (4 joins)."""
    gen = torch.Generator(dev).manual_seed(3)
    join = gspmm.gspmm_join(pg, "u_mul_e_sum", backend="pallas")
    saving = 0.0
    with torch.no_grad():
        for F in (GCN["feat_dim"], GCN["hidden"]):
            x = torch.randn((pg.M, pg.n_loc, F), generator=gen, device=dev)
            calls = {"without": lambda: join(x),
                     "with": lambda: gspmm.gspmm_stats(
                         pg, "u_mul_e_sum", x, backend="pallas")}
            ms = {k: [] for k in calls}
            for fn in calls.values():
                fn()
            for _ in range(reps):
                for k, fn in calls.items():
                    ms[k].append(event_ms(torch, fn)[1])
            med = {k: float(np.median(v)) for k, v in ms.items()}
            saving += 2 * (med["with"] - med["without"])
            log(f"[gcn] one join at F={F}: without the message accounting "
                f"{med['without']:.3f} ms {ms['without']}, with it "
                f"{med['with']:.3f} ms {ms['with']}")
    log(f"[gcn] skipping the message accounting saves {saving:.3f} ms an "
        "epoch (2 joins at each width, medians)")


def gcn_step_oracle(np, A, At, z1, z1_err, p, labels, relu_on):
    """One full-batch step of the 2-layer GCN in float64 with scipy and
    numpy, independent of the port: the mean cross-entropy over the
    labelled rows (every vertex), each leaf's gradient, the global-norm
    clip and AdamW's first step, where m/(1-b1) = g and v/(1-b2) = g^2,
    so the step is -lr * g / (|g| + eps).  ``z1`` is ``A^T emb`` in the
    original vertex order and ``z1_err`` bounds the float32 join's error
    in it.

    The relu's derivative is the card's own (``relu_on``): a float32
    pre-activation within round-off of 0 may fall on either side of it,
    and such a flip moves a gradient by far more than summation order
    does.  Every flip must lie within ``band`` of 0: the join's bound
    carried through ``@ W1``, plus the product's own rounding.  Returns
    (loss, grads, step, grad norm, flips, pre-activations in the band)."""
    n = z1.shape[0]
    abs_w1 = np.abs(p["W1"])
    p1 = z1 @ p["W1"] + p["b1"]
    band = z1_err @ abs_w1 + (z1.shape[1] + 2) * U32 * (
        np.abs(z1) @ abs_w1 + np.abs(p["b1"]))
    in_band = np.abs(p1) <= band
    flips = (p1 > 0) != relu_on
    if (flips & ~in_band).any():
        v, j = np.argwhere(flips & ~in_band)[0]
        fail(f"gcn: the card's relu of pre-activation ({v}, {j}) = "
             f"{p1[v, j]:.6g} flipped beyond its round-off {band[v, j]:.3g}")
    z2 = At @ np.maximum(p1, 0.0)
    logits = z2 @ p["W2"] + p["b2"]
    logits -= logits.max(axis=1, keepdims=True)
    prob = np.exp(logits)
    prob /= prob.sum(axis=1, keepdims=True)
    rows = np.arange(n)
    loss = -np.mean(np.log(prob[rows, labels]))
    d_logits = prob
    d_logits[rows, labels] -= 1.0
    d_logits /= n
    grads = {"W2": z2.T @ d_logits, "b2": d_logits.sum(axis=0)}
    del z2, p1, band
    d_p1 = (A @ (d_logits @ p["W2"].T)) * relu_on
    grads["W1"] = z1.T @ d_p1
    grads["b1"] = d_p1.sum(axis=0)
    grads["emb"] = A @ (d_p1 @ p["W1"].T)
    gnorm = float(np.sqrt(sum(np.sum(v * v) for v in grads.values())))
    scale = min(1.0, GCN_CLIP / max(gnorm, 1e-9))
    step = {k: -GCN["lr"] * (scale * v) / (np.abs(scale * v) + ADAM_EPS)
            for k, v in grads.items()}
    return (loss, grads, step, gnorm, int(flips.sum()),
            int(in_band.sum()))


def check_step(torch, np, eng, pg, params0, A, At, z1, z1_err,
               first_loss):
    """The assembled training step on the card against
    :func:`gcn_step_oracle`.  Each leaf's gradient of the mean loss
    (autograd through both joins, relu and the ``@ W`` products; the
    forward is ``gcn_forward``'s, written out to read the relu) must be
    within GRAD_RTOL of the float64 norm, and its change after one
    ``Engine.run("gcn", epochs=1)`` (clip and AdamW) within STEP_RTOL,
    plus the float32 rounding of the stepped values."""
    from repro_torch.core import gspmm
    from repro_torch.models.embedding import softmax_xent
    from repro_torch.train.gcn import gcn_forward, gcn_labels

    def host(t):
        t = t.detach().cpu().numpy()
        return t.reshape(pg.n_pad, -1)[pg.perm] if t.ndim == 3 else t
    labels, mask = gcn_labels(pg, GCN["n_classes"])
    join = gspmm.gspmm_join(pg, "u_mul_e_sum", backend="pallas")
    p = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
    p1 = join(p["emb"]) @ p["W1"] + p["b1"]
    logits = join(torch.relu(p1)) @ p["W2"] + p["b2"]
    loss = softmax_xent(logits, labels, mask)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    with torch.no_grad():
        ref = gcn_forward(pg, params0, backend="pallas")
        dev_rel = float(torch.linalg.vector_norm(ref - logits)
                        / torch.linalg.vector_norm(logits))
    if not dev_rel <= LOSS_RTOL:
        fail(f"gcn: the written-out forward differs from gcn_forward by "
             f"{dev_rel:.3g}")
    stepped = eng.run("gcn", pg, epochs=1, params=params0, **GCN).state
    p0 = {k: host(v).astype(np.float64) for k, v in params0.items()}
    lab = host(labels).reshape(-1)[pg.perm]
    (loss64, g64, step64, gnorm, n_flip, n_band) = gcn_step_oracle(
        np, A, At, z1, z1_err, p0, lab, host(p1 > 0))
    if abs(first_loss - loss64) > LOSS_RTOL * loss64:
        fail(f"gcn: first loss {first_loss} vs float64 {loss64}")
    norm = np.linalg.norm
    errs = {}
    for k in p:
        eg = norm(host(grads[k]) - g64[k]) / norm(g64[k])
        s1 = host(stepped[k]).astype(np.float64)
        diff = norm((s1 - p0[k]) - step64[k])
        es = diff / norm(step64[k])
        if not (eg <= GRAD_RTOL and diff <= STEP_RTOL * norm(step64[k])
                + U32 * norm(s1)):
            fail(f"gcn step: {k}: gradient rel err {eg:.3g} (limit "
                 f"{GRAD_RTOL}), step rel err {es:.3g} (limit {STEP_RTOL}) "
                 "against float64")
        errs[k] = (eg, es)
    log(f"[check] gcn step vs float64 scipy/numpy: loss {first_loss:.7f} "
        f"vs {loss64:.7f}; grad norm {gnorm:.4g}; {n_flip} of {n_band} "
        "pre-activations within round-off of 0 on the other side of the "
        "relu; per leaf |g - g64|/|g64|, |step - step64|/|step64|: "
        + ", ".join(f"{k} {a:.2g}, {b:.2g}" for k, (a, b) in errs.items())
        + f" (limits {GRAD_RTOL}, {STEP_RTOL})")


# ---------------------------------------------------------------------------
# phase 5: pallas == dense at n=200k
# ---------------------------------------------------------------------------

def parity_small(torch, np, args, dev, phases):
    from repro_torch import api
    from repro_torch.core import cost_model, gspmm
    from repro_torch.graph import generators as gen
    from repro_torch.train.gcn import normalize_adjacency
    g = normalize_adjacency(gen.powerlaw(
        PARITY_N, avg_deg=8, seed=args.seed, weighted=True).symmetrized())
    M = args.workers
    tau = cost_model.choose_tau(g.out_degrees(), M)
    engines = {b: api.Engine(backend=b, layout="csr", balance="hash",
                             device=dev) for b in ("pallas", "dense")}
    pg = engines["pallas"].partition(g, M, tau=tau, seed=args.seed)
    x = torch.randn((pg.M, pg.n_loc, GCN["feat_dim"]), device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    x = torch.where(pg.vmask[..., None], x, 0.0)
    worst = 0.0
    for kind in gspmm.GSPMM_KINDS:
        a, sa = gspmm.gspmm_stats(pg, kind, x, backend="pallas")
        b, sb = gspmm.gspmm_stats(pg, kind, x, backend="dense")
        assert_stats_equal(np, kind, sa, sb)
        if kind == "u_mul_e_max":
            if not torch.equal(a, b):
                fail(f"{kind}: pallas != dense at n={PARITY_N}")
            continue
        mag, _ = gspmm.gspmm_stats(pg, kind, x.abs(), backend="dense")
        worst = max(worst, within_sum_bound(
            np, f"{kind} pallas vs dense", a.cpu().numpy(),
            b.cpu().numpy(), mag.cpu().numpy(), None, factor=1e-5))
    hist = {b: e.run("gcn", pg, epochs=3, **GCN).history
            for b, e in engines.items()}
    # the backends differ in summation order only: a few float32 ulps of a
    # loss near ln(8) (2.4e-7 each), far below the history's fall
    fall = hist["dense"][0] - hist["dense"][-1]
    if not (np.allclose(hist["pallas"], hist["dense"], rtol=0, atol=1e-6)
            and fall > 1e-4):
        fail(f"gcn loss pallas {hist['pallas']} vs dense {hist['dense']}")
    log(f"[check] pallas == dense at n={PARITY_N} on the card: max bitwise, "
        f"sums max |err|/(|A|^T|X|) {worst:.3g} (limit 1e-5), every "
        f"msgs_*/per_worker_* equal; gcn loss {hist['pallas']} vs "
        f"{hist['dense']} (atol=1e-6; it falls by {fall:.3g})")


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
    vec_err = phases.run("vec-kernel-vs-plain", random_vec_cases, torch, np,
                         kernel, ref_fn, dev, args.seed)
    mods = (api, structs, gen, cost_model, planlib, kernel)
    g, A, pg, launches, algos = main_path(torch, np, mods, args, dev,
                                          phases)
    vec_launches, gcn_peak, inputs = gcn_path(torch, np, args, dev, phases,
                                              g, A, pg)
    del g, A
    phases.run("parity-200k", parity_small, torch, np, args, dev, phases)
    eng = api.Engine(backend="pallas", layout="csr", balance="hash",
                     device=dev)
    plans = {k: planlib.get_plan(pg, k) for k in ("eg", "mir")}
    kinds = {(p.n_rows, p.eb): k for k, p in plans.items()}
    rows = phases.run("kernel-timing", algo_launches, torch, kernel, ref_fn,
                      eng, pg, algos, kinds)
    if sum(r["launches"] for r in rows) != launches:
        fail(f"{sum(r['launches'] for r in rows)} scalar launches timed, "
             f"{launches} in the counted algorithm runs")
    vec_rows = phases.run("vec-kernel-timing", gcn_launches, torch, planlib,
                          kernel, ref_fn, pg, inputs)
    del inputs
    timed_launches = sum(r["launches"] for r in vec_rows)
    if timed_launches != vec_launches:
        fail(f"{timed_launches} vector launches timed, {vec_launches} in the "
             "counted GCN run")
    import resource
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[device] peak device memory of the GCN path "
        f"{gcn_peak / 2**30:.2f} GiB, of the timing phases "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; peak host RSS "
        f"{host_gib:.2f} GiB; phases {json.dumps(phases.seconds)}")
    # every launch of the counted algorithm runs
    entry = {
        "name": "segment_combine_blocks", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max([rand_err] + [r["max_abs_err"] for r in rows]),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in rows),
        "per_launch": rows,
    }
    # every launch of the counted GCN run: GCN_EPOCHS epochs of 4 joins
    vec_entry = {
        "name": "segment_combine_blocks_vec", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": VEC_KERNEL_REPLACES,
        "launches": vec_launches,
        "max_abs_err": max([vec_err] + [r["max_abs_err"] for r in vec_rows]),
        "ms": sum(r["ms"] for r in vec_rows),
        "plain_ms": sum(r["plain_ms"] for r in vec_rows),
        "bound_ms": sum(r["bound_ms"] for r in vec_rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in vec_rows) else "operations"),
        "library_ms": sum(r["library_ms"] for r in vec_rows),
        "epochs": GCN_EPOCHS,
        "per_launch": vec_rows,
    }
    E = GCN_EPOCHS
    log(f"[kernel] segment_combine_blocks_vec: {vec_launches} launches in "
        f"{E} epochs: kernel {vec_entry['ms']:.3f} ms ({vec_entry['ms'] / E:.3f}"
        f" an epoch), plain {vec_entry['plain_ms']:.3f} "
        f"({vec_entry['plain_ms'] / E:.3f}), library "
        f"{vec_entry['library_ms']:.3f} ({vec_entry['library_ms'] / E:.3f}), "
        f"bound {vec_entry['bound_ms']:.3f} ({vec_entry['bound_ms'] / E:.3f})")
    log(json.dumps({"kernels": [entry, vec_entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
