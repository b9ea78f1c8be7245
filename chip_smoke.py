#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--n 4000000] [--workers 32] [--seed 0]

Phases; any failure exits non-zero and prints no result:

1. device: CUDA must be present; prints the card's name and power limit
   (nvidia-smi) and builds the three kernel sources from ``src/``
   (segment_combine, flash_attention, ssd_scan: one nvcc each, started
   together), printing each ``-Xptxas -v`` report.
2. kernels vs plain: random cases (sum/min/max x int32/float32 x several
   (eb, nb), eb=0 and eb=2048 with nb=1024 among them, for the vector
   kernel x F in {1, 3, 32, 64, 130}; -1 padding, indices nb and beyond, a
   row with every lane on one slot and an all-padding row, values at the
   int32 bounds and +-inf) against the plain PyTorch version on the same
   inputs.  Integers and min/max must be bitwise equal; a
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
   same runs; each line and entry adds kernel/library and bound/kernel.
7. serve Hymba-1.5B at full width (32 layers, d_model 1600, 25/5 heads,
   window 1024 with layers 16 and 32 global, a Mamba-2 mixer beside the
   attention in every layer; 1.64B parameters in float32 from
   ``torch.Generator(seed)`` on the card; TF32 off).  First the two new
   kernels against their plain versions in float64 on random cases (flash:
   causal on/off x window 0/16/1024 x n_rep 1/5 x d 16/64/128 x S
   64/100/2048/2112, within 1e-5 of max|v|, and bfloat16 within 2e-2;
   SSD: S a chunk multiple and ragged x (P, N) (64, 16)/(64, 128) x groups
   1/2, y and final state within 1e-4 of their max).  Then B=4 random
   prompts of 2048 tokens (twice the window, so the masks and ring buffers
   wrap): prefill and 63 greedy decode steps through ``model_zoo``, timed
   with CUDA events.  Checks: (a) both kernels on every launch's recorded
   inputs against the float64 plain version; (b) each layer's update with
   the kernels against the plain path ("ref") on the same input; (c) the
   prefill + decode path against the no-cache forward over the 2112 tokens
   (both kernels at that ragged length), layer by layer with teacher
   forcing at positions 2047..2110, and the logits through the last layer;
   (d) 32 flash and 32 SSD launches in the prefill, none in decode; (e)
   finite logits, the padded vocabulary at -2^30.  The whole-model logits
   (kernels vs plain, served decode vs forward) are printed but not held to
   a bound: the random-weight 32-layer model amplifies float32 rounding.
   ``[serve]`` lines give the prefill and decode device times, tokens/s
   and peak memory; ``[kernel]`` lines each kernel's time, plain time,
   library time (SDPA for flash; none for the scan) and bound over the 32
   launches of a prefill.

One JSON line ``{"kernels": [...]}`` with all four kernels, then the last
line ``{"ok": true, "device": {...}}``.
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
LM_ARCH = "hymba_1_5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 64
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:27"
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:20"
# Tolerances of the serve phase.  Random cases (scores ~N(0, 1)): the
# flash kernel sums each query's d-long products and Sk weighted rows in
# float32 in another order than the plain version, ~1e-6 of max|v|.
FLASH_F32_TOL = 1e-5
FLASH_BF16_TOL = 2e-2      # bfloat16 output rounding, as the JAX tests
LIB_TOL = 1e-4             # SDPA (another float32 order) vs float64
# the chunked scan takes exp of differences of float32 cumulative sums
# (|cum| up to ~100 in a chunk: ~1e-5 relative), the oracle is the float64
# recurrence
SSD_RTOL = 1e-4
# On the path's own inputs the scores reach the hundreds, and rounding a
# score to float32 (~1e-5 there) becomes a relative error of its softmax
# weight: both the kernel and the float32 plain version sit ~5e-5 of
# max|v| from float64, above the 1e-5 that holds for random cases.  There
# each kernel is held to the larger of its random-case bound and
# PLAIN_FACTOR times the float32 plain version's own distance from the
# float64 oracle: no less accurate than the plain float32 computation.
PLAIN_FACTOR = 4.0
# a layer's update on the same input, kernels vs plain path, or prefill +
# decode vs the no-cache forward: float32 order and the conditioning
# above (attention, scan and MLP errors of ~1e-5..1e-4 of the update's
# max); a mask, GQA, state or ring-buffer fault moves it by O(1)
LAYER_RTOL = 1e-3
LOGIT_RTOL = 1e-3


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


def build_kernels():
    """Build the three kernel sources, one nvcc each, all started together,
    and print each build's -Xptxas -v report."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.segment_combine import kernel as sc
    from repro_torch.kernels.ssd_scan import kernel as ssd
    t0 = time.perf_counter()
    infos = _build.build_libraries([(m.SOURCE, m.LIB_NAME)
                                    for m in (sc, flash, ssd)])
    for info in infos:
        log(f"[build] {info['path'].name}: built={info['built']} in "
            f"{info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "smem" in line):
                log(f"[ptxas] {info['name']}: {line.strip()}")
    log(f"[build] all sources in {time.perf_counter() - t0:.2f} s")


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


def random_idx(np, rng, R, eb, nb):
    """Random block-local indices in [-1, nb + 3), so padding, nb and
    beyond appear; row 0 (if R > 1) has all its lanes on one slot, row 1
    (if R > 2) is all padding."""
    idx = rng.randint(-1, nb + 3, (R, eb)).astype(np.int32)
    if R > 1:
        idx[0] = rng.randint(0, nb)
    if R > 2:
        idx[1] = -1
    return idx


def random_cases(torch, np, kernel, ref_fn, dev, seed):
    rng = np.random.RandomState(seed)
    info = np.iinfo(np.int32)
    max_err = 0.0
    n_cases = 0
    for op in ("sum", "min", "max"):
        for dtype in (torch.int32, torch.float32):
            for eb, nb in [(8, 32), (64, 128), (512, 32), (512, 128),
                           (37, 100), (1, 1), (0, 16), (2048, 1024)]:
                R = int(rng.randint(1, 4000))
                idx = random_idx(np, rng, R, eb, nb)
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
    log(f"[kernel] {n_cases} random cases (skewed, all-padding and "
        f"out-of-range rows) match the plain version (max |err| "
        f"{max_err:.3g})")
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
                           (64, 1024), (0, 8), (2048, 1024)]:
                for F in (1, 3, 32, 64, 130):
                    R = int(rng.randint(1, max(2, 2 ** 22 // (max(eb, 1)
                                                               * F))))
                    R = min(R, 2000)
                    idx = random_idx(np, rng, R, eb, nb)
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
    log(f"[kernel] {n_cases} random vector cases (skewed, all-padding and "
        f"out-of-range rows) match the plain version (max |err| "
        f"{max_err:.3g}); F=1 equals the scalar kernel bitwise")
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
    (``ops_of``) at the float32 rate; and its ratios."""
    for row in rows:
        row["bytes"] = bytes_of(row)
        t_bytes = row["bytes"] / HBM_BYTES_PER_S
        t_ops = ops_of(row) / FP32_OPS_PER_S
        row["bound_ms"] = max(t_bytes, t_ops) * 1e3
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        add_ratios(row)


def add_ratios(row):
    """``kernel_over_library`` (below 1: the kernel is faster than the
    library call) and ``bound_over_kernel`` (the share of the bound the
    kernel reaches) of a row or a kernels-line entry."""
    row["kernel_over_library"] = row["ms"] / row["library_ms"]
    row["bound_over_kernel"] = row["bound_ms"] / row["ms"]
    return row


def ratio_text(row) -> str:
    return (f"kernel/library {row['kernel_over_library']:.3f}, "
            f"bound/kernel {row['bound_over_kernel']:.3f}")


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
            f"{r['bound_ms']:.4f} ({r['bound_ms'] / n:.4f}) ms; "
            f"{ratio_text(r)}")
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
            f"({row['bytes'] / 1e9:.3f} GB); {ratio_text(row)}")
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


# ---------------------------------------------------------------------------
# phase 7: serve Hymba-1.5B at full width
# ---------------------------------------------------------------------------

def flash_pairs(S: int, window: int) -> int:
    """Query-key pairs a causal mask (and a window, if any) keeps for
    Sq = Sk = S."""
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def flash_random_cases(torch, np, dev, seed):
    """The flash kernel against its plain version in float64 (the oracle)
    over causal x window x n_rep x d x S, float32 within FLASH_F32_TOL of
    max|v|; bfloat16 inputs against the float32 plain version within
    FLASH_BF16_TOL.  Returns the largest |kernel - oracle| in float32."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(dev).manual_seed(seed + 7)
    worst, worst_plain, n = 0.0, 0.0, 0
    for S in (64, 100, 2048, 2112):
        for d in (16, 64, 128):
            for n_rep in (1, 5):
                BKV = 2
                q = torch.randn((BKV * n_rep, S, d), generator=gen, device=dev)
                k = torch.randn((BKV, S, d), generator=gen, device=dev)
                v = torch.randn((BKV, S, d), generator=gen, device=dev)
                q64, k64, v64 = q.double(), k.double(), v.double()
                for causal in (True, False):
                    for window in (0, 16, 1024):
                        got = fk.launch(q, k, v, causal=causal, window=window)
                        want = flash_attention_ref(q64, k64, v64,
                                                   causal=causal,
                                                   window=window)
                        plain = flash_attention_ref(q, k, v, causal=causal,
                                                    window=window)
                        torch.cuda.synchronize()
                        err = float((got.double() - want).abs().max())
                        lim = FLASH_F32_TOL * float(v.abs().max())
                        if not err <= lim:
                            fail(f"flash kernel vs float64 plain: |err| {err:.3g}"
                                 f" > {lim:.3g} (S={S}, d={d}, n_rep={n_rep}, "
                                 f"causal={causal}, window={window})")
                        worst = max(worst, err)
                        worst_plain = max(worst_plain, float(
                            (plain.double() - want).abs().max()))
                        n += 1
    log(f"[kernel] flash_attention: {n} random float32 cases within "
        f"{FLASH_F32_TOL} x max|v| of the float64 plain version (max |err| "
        f"{worst:.3g}; the float32 plain version's own {worst_plain:.3g})")
    bf_worst = 0.0
    for S, window in ((2048, 0), (2048, 1024), (2112, 16)):
        q = torch.randn((10, S, 64), generator=gen, device=dev)
        k = torch.randn((2, S, 64), generator=gen, device=dev)
        v = torch.randn((2, S, 64), generator=gen, device=dev)
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        got = fk.launch(qb, kb, vb, causal=True, window=window)
        want = flash_attention_ref(qb.float(), kb.float(), vb.float(),
                                   causal=True, window=window)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            fail(f"flash kernel returned {got.dtype} for bfloat16 inputs")
        err = float((got.float() - want).abs().max())
        if not err <= FLASH_BF16_TOL:
            fail(f"bfloat16 flash kernel vs float32 plain: |err| {err:.3g} > "
                 f"{FLASH_BF16_TOL} (S={S}, window={window})")
        bf_worst = max(bf_worst, err)
    log(f"[kernel] flash_attention: 3 bfloat16 cases within {FLASH_BF16_TOL} "
        f"of the float32 plain version (max |err| {bf_worst:.3g})")
    return worst


def ssd_case_err(torch, got, want):
    """max |got - want| / max |want| (0 for an all-zero want)."""
    scale = float(want.abs().max())
    return float((got.double() - want).abs().max()) / max(scale, 1e-30)


def ssd_random_cases(torch, np, dev, seed):
    """The SSD kernel against the float64 recurrence (its plain version in
    float64): y and the final state within SSD_RTOL of their max, at S a
    multiple of the chunk and ragged, (P, N) in {(64, 16), (64, 128)},
    groups 1 and 2, with and without an initial state."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    gen = torch.Generator(dev).manual_seed(seed + 8)
    worst, n = 0.0, 0
    for S in (256, 200, 2112):
        for P, N in ((64, 16), (64, 128)):
            for g, init in ((1, False), (2, True)):
                b, h, chunk = 2, 4, 128
                x = torch.randn((b, S, h, P), generator=gen, device=dev)
                dt = torch.nn.functional.softplus(torch.randn(
                    (b, S, h), generator=gen, device=dev) - 1.0)
                A = -torch.exp(0.5 * torch.randn((h,), generator=gen,
                                                 device=dev))
                B = torch.randn((b, S, g, N), generator=gen, device=dev)
                C = torch.randn((b, S, g, N), generator=gen, device=dev)
                s0 = (torch.randn((b, h, P, N), generator=gen, device=dev)
                      if init else None)
                y, st = sk.launch(x, dt, A, B, C, chunk=chunk, init_state=s0)
                y64, st64 = ssd_scan_ref_model(
                    x.double(), dt.double(), A.double(), B.double(),
                    C.double(), None if s0 is None else s0.double())
                torch.cuda.synchronize()
                ey = ssd_case_err(torch, y, y64)
                es = ssd_case_err(torch, st, st64)
                if not (ey <= SSD_RTOL and es <= SSD_RTOL):
                    fail(f"SSD kernel vs float64 recurrence: y {ey:.3g}, "
                         f"state {es:.3g} of max (limit {SSD_RTOL}; S={S}, "
                         f"P={P}, N={N}, g={g}, init={init})")
                worst = max(worst, ey, es)
                n += 1
    log(f"[kernel] ssd_scan: {n} random cases, y and final state within "
        f"{SSD_RTOL} of their max against the float64 recurrence (max "
        f"{worst:.3g})")
    return worst


def _slice_tree(tree, i):
    return {k: _slice_tree(v, i) if isinstance(v, dict) else v[i:i + 1]
            for k, v in tree.items()}


def one_layer_stages(params, cfg):
    """Every layer of the model as a one-layer stage, in order:
    (StageSpec, stage params), run by the model's own apply_stage_seq /
    apply_stage_decode."""
    from repro_torch.models.transformer import StageSpec, build_stages
    out = []
    for sp, stage in zip(params["stages"], build_stages(cfg)):
        for i in range(stage.n_layers):
            out.append((StageSpec(stage.kind, 1, stage.window),
                        {"layers": _slice_tree(sp["layers"], i)}))
    return out


def record_launches(mods, fn):
    """Run ``fn`` with each module's ``launch`` wrapped to keep a copy of
    every launch's arguments; returns {module name: [(args, kw), ...]}."""
    seen = {name: [] for name in mods}
    saved = {name: m.launch for name, m in mods.items()}

    def wrap(name):
        def rec(*a, **kw):
            seen[name].append((tuple(t.clone() if hasattr(t, "clone") else t
                                     for t in a), dict(kw)))
            return saved[name](*a, **kw)
        return rec
    for name, m in mods.items():
        m.launch = wrap(name)
    try:
        fn()
    finally:
        for name, m in mods.items():
            m.launch = saved[name]
    return seen


def flash_rows(torch, launches, fk, flash_ref):
    """Time the flash kernel on each recorded launch of the counted prefill
    (kernel, plain version, and SDPA on kv repeated, with the window as a
    boolean mask), hold the kernel against the float64 plain version and
    SDPA against the float32 plain version; one row per launch."""
    F = torch.nn.functional
    rows = []
    for idx, ((q, k, v), kw) in enumerate(launches):
        BH, S, d = q.shape
        BKV = k.shape[0]
        rep = BH // BKV
        window = kw["window"]
        kr = torch.repeat_interleave(k, rep, dim=0)[None]
        vr = torch.repeat_interleave(v, rep, dim=0)[None]
        if window:
            pos = torch.arange(S, device=q.device)
            dq = pos[:, None] - pos[None, :]
            mask = (dq >= 0) & (dq < window)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], kr, vr, attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], kr, vr, is_causal=True)
        fns = {"ms": lambda: fk.launch(q, k, v, **kw),
               "plain_ms": lambda: flash_ref(q, k, v, **kw),
               "library_ms": lib}
        if idx == 0:                                   # warm-up, not timed
            for fn in fns.values():
                fn()
        row = {"launch": f"layer{idx}", "window": window, "BH": BH,
               "S": S, "d": d, "n_rep": rep}
        outs = {}
        for key, fn in fns.items():
            outs[key], row[key] = event_ms(torch, fn)
        want = flash_ref(q.double(), k.double(), v.double(), **kw)
        vmax = float(v.abs().max())
        row["max_abs_err"] = float((outs["ms"].double() - want).abs().max())
        row["plain_err"] = float((outs["plain_ms"].double() - want).abs().max())
        row["rel_err"] = row["max_abs_err"] / vmax
        row["plain_rel_err"] = row["plain_err"] / vmax
        lim = max(FLASH_F32_TOL * vmax, PLAIN_FACTOR * row["plain_err"])
        if not row["max_abs_err"] <= lim:
            fail(f"flash kernel at the path's shapes (layer {idx}): |err| "
                 f"{row['max_abs_err']:.3g} > {lim:.3g} (the float32 plain "
                 f"version's {row['plain_err']:.3g}, max|v| {vmax:.3g})")
        lib_err = float((outs["library_ms"][0].double() - want).abs().max())
        if not lib_err <= LIB_TOL * vmax:
            fail(f"SDPA does not compute the flash kernel's function (layer "
                 f"{idx}): |err| {lib_err:.3g}")
        if not kw["causal"]:
            fail(f"a non-causal flash launch on the serving path (layer {idx})")
        pairs = flash_pairs(S, window)
        row["ops"] = 4 * d * pairs * BH
        row["bytes"] = 4 * (2 * BH * S * d + 2 * BKV * S * d)
        rows.append(row)
        del want, outs, kr, vr
    return rows


def ssd_rows(torch, launches, sk, ssd_ref):
    """Time the SSD kernel on each recorded launch of the counted prefill
    (kernel and plain version; no single PyTorch call computes the scan)
    and hold y and the final state against the float64 recurrence; one
    row per launch."""
    rows = []
    for idx, ((x, dt, A, B, C), kw) in enumerate(launches):
        b, S, h, P = x.shape
        g, N = B.shape[2], B.shape[3]
        Q = kw["chunk"]
        fns = {"ms": lambda: sk.launch(x, dt, A, B, C, **kw),
               "plain_ms": lambda: ssd_ref(x, dt, A, B, C)}
        if idx == 0:
            for fn in fns.values():
                fn()
        row = {"launch": f"layer{idx}", "b": b, "S": S, "h": h, "P": P,
               "N": N, "g": g, "chunk": Q}
        outs = {}
        for key, fn in fns.items():
            outs[key], row[key] = event_ms(torch, fn)
        y64, st64 = ssd_ref(x.double(), dt.double(), A.double(), B.double(),
                            C.double())
        y, st = outs["ms"]
        ey, es = ssd_case_err(torch, y, y64), ssd_case_err(torch, st, st64)
        py, ps = outs["plain_ms"]
        row["plain_rel_err"] = max(ssd_case_err(torch, py, y64),
                                   ssd_case_err(torch, ps, st64))
        lim = max(SSD_RTOL, PLAIN_FACTOR * row["plain_rel_err"])
        if not (ey <= lim and es <= lim):
            fail(f"SSD kernel at the path's shapes (layer {idx}): y {ey:.3g},"
                 f" state {es:.3g} of max (limit {lim:.3g}; the float32 "
                 f"plain version's {row['plain_rel_err']:.3g})")
        row["max_abs_err"] = float((y.double() - y64).abs().max())
        row["rel_err"] = max(ey, es)
        tri = Q * (Q + 1) // 2
        n_chunks = -(-S // Q)
        row["ops"] = b * h * n_chunks * (2 * tri * (N + P) + 4 * Q * P * N)
        row["bytes"] = 4 * (2 * b * S * h * P + b * S * h + 2 * b * S * g * N
                            + b * h * P * N + h)
        rows.append(row)
        del y64, st64, outs
    return rows


def kernel_entry(name, source, replaces, launches, rows, rand_err, library):
    """One entry of the kernels JSON line: the sums over the rows (one a
    launch of the counted run), the bound from their bytes and operations."""
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
    t_ops = sum(r["ops"] for r in rows) / FP32_OPS_PER_S
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max([rand_err] + [r["max_abs_err"] for r in rows]),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": (sum(r["library_ms"] for r in rows) if library
                       else None),
        "per_launch": rows,
    }


def rel_max(torch, got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


def per_layer_kernels_vs_plain(torch, cfg, zoo, tf, params, prompts, layers):
    """Check (b): each layer's update h_{l+1} - h_l with the kernels
    ("auto") against the same layer's plain path ("ref") on the same input
    (the kernels' run's h_l), within LAYER_RTOL of its max.  Returns the
    worst relative error and the kernels' final hidden state."""
    B, S = prompts.shape
    pos = torch.arange(S, dtype=torch.int32, device=prompts.device).expand(B, S)
    auto = tf.ModelContext(q_chunk=max(S, 64))
    ref = tf.ModelContext(q_chunk=max(S, 64), kernels="ref")
    h = zoo._embed_in(params, cfg, prompts, auto)
    errs = []
    for stage, sp in layers:
        h_k = tf.apply_stage_seq(h, sp, stage, cfg, auto, pos)[0]
        h_r = tf.apply_stage_seq(h, sp, stage, cfg, ref, pos)[0]
        errs.append(rel_max(torch, h_k - h, h_r - h))
        h = h_k
    log("[check] (b) per layer: " + ", ".join(f"{e:.2g}" for e in errs))
    for li, ((stage, _), err) in enumerate(zip(layers, errs)):
        if not err <= LAYER_RTOL:
            fail(f"layer {li} ({stage.kind}, window {stage.window}): the "
                 f"kernels' update differs from the plain path's by {err:.3g}"
                 f" of its max (limit {LAYER_RTOL})")
    return max(errs), h


def per_layer_decode_vs_forward(torch, cfg, zoo, tf, params, seq, n_prompt,
                                layers):
    """Check (c), layer by layer with teacher forcing: the no-cache forward
    ("auto": both kernels, at the ragged length of ``seq``) gives each
    layer's input H_l at every position.  For each layer, the prefill path
    runs H_l over the prompt and builds the cache, then the decode path
    runs the next positions one token at a time on H_l.  At positions
    n_prompt-1 (the prefill's last) .. S-2 the layer's update must match
    the forward's within LAYER_RTOL of its max, and the last layer's
    outputs through the final norm and the logits must match the
    forward's logits within LOGIT_RTOL.  Returns (worst layer error, logit
    error, positions checked)."""
    B, S = seq.shape
    steps = S - n_prompt - 1             # decode at n_prompt .. S-2
    lo, hi = n_prompt - 1, S - 1         # the positions checked
    pos = torch.arange(S, dtype=torch.int32, device=seq.device).expand(B, S)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    h = zoo._embed_in(params, cfg, seq, ctx)
    errs = []
    for stage, sp in layers:
        h_next = tf.apply_stage_seq(h, sp, stage, cfg, ctx, pos)[0]
        clen = zoo._stage_cache_len(stage, S)
        h_pre, cache, _ = tf.apply_stage_seq(
            h[:, :n_prompt], sp, stage, cfg, ctx, pos[:, :n_prompt],
            want_cache=True, cache_len=clen)
        if stage.kind != "ssm":
            cache["k_pos"] = tf.stage_kpos(B, n_prompt, clen, seq.device)
        p = torch.full((B,), n_prompt, dtype=torch.int32, device=seq.device)
        outs = [h_pre[:, -1:]]
        for i in range(steps):
            t = n_prompt + i
            o, cache = tf.apply_stage_decode(h[:, t:t + 1], sp, stage, cfg,
                                             ctx, p + i, cache)
            outs.append(o)
        dec = torch.cat(outs, dim=1)
        base = h[:, lo:hi]
        errs.append(rel_max(torch, dec - base, h_next[:, lo:hi] - base))
        h, last = h_next, dec
        del cache, h_pre, outs
    log("[check] (c) per layer: " + ", ".join(f"{e:.2g}" for e in errs))
    for li, ((stage, _), err) in enumerate(zip(layers, errs)):
        if not err <= LAYER_RTOL:
            fail(f"layer {li} ({stage.kind}, window {stage.window}): prefill "
                 f"+ decode differ from the no-cache forward by {err:.3g} of "
                 f"the update's max (limit {LAYER_RTOL})")
    from repro_torch.models import embedding as emb
    from repro_torch.models.layers import rms_norm

    def logits(x):
        return emb.logits_matmul(rms_norm(x, params["final_norm"],
                                          cfg.norm_eps),
                                 params["out_embed"])[..., :cfg.vocab]
    lerr = rel_max(torch, logits(last), logits(h[:, lo:hi]))
    if not lerr <= LOGIT_RTOL:
        fail(f"decode logits differ from the no-cache forward's by {lerr:.3g}"
             f" of the max (limit {LOGIT_RTOL})")
    return max(errs), lerr, hi - lo


def profile_kernels(torch, fn, name: str, top: int = 10):
    """Where the device time of one call of ``fn`` goes, by device kernel
    (torch.profiler; the ctypes-launched kernels appear under their own
    names): the busy share of the wall time and the kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.events():
        if e.device_type == cuda:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    if busy <= 0:
        log(f"[profile] {name}: the profiler saw no device time "
            "(not measured)")
        return
    log(f"[profile] {name}: wall {wall_us / 1e3:.3f} ms (profiled), device "
        f"busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.1f}%, "
        f"{sum(n for n, _ in by_name.values())} kernels")
    for kname, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[profile] {name}:   {kname[:70]:70s} calls={n:5d} "
            f"device={us / 1e3:9.3f} ms ({100 * us / busy:5.1f}%)")


def serve_path(torch, np, args, dev, phases):
    """Phase 7: Hymba-1.5B at full width (32 layers, d_model 1600, float32,
    random weights from torch.Generator(seed) on the card) serves B=4
    random prompts of 2048 tokens: prefill, then 63 greedy decode steps (64
    generated tokens), through model_zoo.prefill / decode_step, the
    functions serve_model.run calls.  Returns the two kernels' JSON
    entries."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer as tf

    log(f"[serve] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} (float32 products in full "
        f"float32), float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    flash_err = phases.run("flash-vs-plain", flash_random_cases, torch, np,
                           dev, args.seed)
    ssd_err = phases.run("ssd-vs-plain", ssd_random_cases, torch, np, dev,
                         args.seed)
    cfg = get_config(LM_ARCH)
    params = phases.run("lm-init", lambda: zoo.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev))
    torch.cuda.synchronize()
    n_par = zoo.n_params(params)
    stages = tf.build_stages(cfg)
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hd}, ssm "
        f"{cfg.n_ssm_heads} heads x P={cfg.ssm.head_dim} x N="
        f"{cfg.ssm.d_state}, vocab {cfg.vocab} (padded "
        f"{cfg.padded_vocab(1)}); {n_par:,} parameters float32 "
        f"({4 * n_par / 1e9:.2f} GB; param_counts()['total'] "
        f"{cfg.param_counts()['total']:,} unpadded); stages "
        + ", ".join(f"{s.kind}x{s.n_layers}(w={s.window})" for s in stages))
    B, S, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    rng = np.random.RandomState(args.seed)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    ctx = tf.ModelContext(q_chunk=max(S, 64))
    n_attn = sum(s.n_layers for s in stages if s.kind != "ssm")
    n_ssm = sum(s.n_layers for s in stages if s.kind != "dense")

    def serve():
        with torch.no_grad():
            logits, cache = zoo.prefill(params, cfg, ctx, prompts,
                                        max_len=S + G)
            step_logits, toks = [logits], [zoo.greedy(logits)]
            for _ in range(G - 1):
                logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1],
                                                cache)
                step_logits.append(logits)
                toks.append(zoo.greedy(logits))
        return step_logits, torch.cat(toks, dim=1)

    # one untimed warm run (the caching allocator's growth, cuBLAS set-up)
    phases.run("serve-warm", serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.flash_attention_bhsd.launches = 0             # the path starts here
    sk.ssd_chunk_scan.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(G + 1)]
    t0 = time.perf_counter()
    with torch.no_grad():
        ev[0].record()
        logits, cache = zoo.prefill(params, cfg, ctx, prompts, max_len=S + G)
        ev[1].record()
        pre_launches = (fk.flash_attention_bhsd.launches,
                        sk.ssd_chunk_scan.launches)
        step_logits, toks = [logits], [zoo.greedy(logits)]
        for i in range(G - 1):
            logits, cache = zoo.decode_step(params, cfg, ctx, toks[-1], cache)
            ev[i + 2].record()
            step_logits.append(logits)
            toks.append(zoo.greedy(logits))
        gen_toks = torch.cat(toks, dim=1)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = (fk.flash_attention_bhsd.launches,     # ... and ends here
                sk.ssd_chunk_scan.launches)
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = [ev[i + 1].elapsed_time(ev[i + 2]) for i in range(G - 1)]
    log(f"[serve] {cfg.name}: batch={B} prompt={S} gen={G}: prefill "
        f"{prefill_ms:.3f} ms device ({B * S / prefill_ms * 1e3:.0f} prompt "
        f"tokens/s), decode {float(np.mean(decode_ms)):.3f} ms a step "
        f"(median {float(np.median(decode_ms)):.3f}, {G - 1} steps), "
        f"{host_s:.3f} s host for the request ({B * G / host_s:.1f} "
        f"generated tokens/s); peak device memory {peak / 2**30:.2f} GiB")
    log(f"[serve] launches in the counted run: prefill {pre_launches[0]} "
        f"flash, {pre_launches[1]} SSD; decode {launches[0] - pre_launches[0]}"
        f" flash, {launches[1] - pre_launches[1]} SSD")
    # (d) the launch counters
    if pre_launches != (n_attn, n_ssm) or launches != pre_launches:
        fail(f"serve: launches (flash, SSD) {pre_launches} in the prefill, "
             f"{launches} in all, expected ({n_attn}, {n_ssm}) and none in "
             "decode: the path did not go through the kernels")
    # (e) finite logits
    for i, lg in enumerate(step_logits):
        if not bool(torch.isfinite(lg).all()):
            fail(f"serve: non-finite logits at step {i}")
    pad = step_logits[0][:, cfg.vocab:]
    if pad.numel() and not bool((pad == -2.0 ** 30).all()):
        fail("serve: the padded vocabulary's logits are not -2^30")
    log(f"[serve] sample generations (token ids): "
        f"{gen_toks[0, :16].tolist()}")
    phases.run("profile-prefill", profile_kernels, torch, lambda: zoo.prefill(
        params, cfg, ctx, prompts, max_len=S + G), "prefill")
    phases.run("profile-decode", profile_kernels, torch,
               lambda: zoo.decode_step(params, cfg, ctx, toks[-1], cache),
               "decode step")

    # (a) both kernels at the path's shapes, on a replay's recorded inputs
    seen = phases.run("serve-record", record_launches,
                      {"flash": fk, "ssd": sk},
                      lambda: zoo.prefill(params, cfg, ctx, prompts,
                                          max_len=S + G))
    f_rows = phases.run("flash-timing", flash_rows, torch, seen["flash"],
                        fk, flash_attention_ref)
    s_rows = phases.run("ssd-timing", ssd_rows, torch, seen["ssd"], sk,
                        ssd_scan_ref_model)
    del seen
    if len(f_rows) != launches[0] or len(s_rows) != launches[1]:
        fail(f"{len(f_rows)} flash / {len(s_rows)} SSD launches timed, "
             f"{launches} in the counted prefill")
    log(f"[check] (a) both kernels on the prefill's own inputs against the "
        f"float64 plain version: flash max |err| / max|v| "
        f"{max(r['rel_err'] for r in f_rows):.3g} (the float32 plain "
        f"version's {max(r['plain_rel_err'] for r in f_rows):.3g}), SSD max "
        f"rel {max(r['rel_err'] for r in s_rows):.3g} (plain "
        f"{max(r['plain_rel_err'] for r in s_rows):.3g}); limits: the larger "
        f"of {FLASH_F32_TOL} / {SSD_RTOL} and {PLAIN_FACTOR} x the plain "
        "version's")
    log("[check] (a) per layer, flash |err|/max|v| (plain): " + ", ".join(
        f"{r['rel_err']:.2g} ({r['plain_rel_err']:.2g})" for r in f_rows))
    log("[check] (a) per layer, SSD rel err (plain): " + ", ".join(
        f"{r['rel_err']:.2g} ({r['plain_rel_err']:.2g})" for r in s_rows))

    # (b) kernels against the plain path
    layers = one_layer_stages(params, cfg)
    with torch.no_grad():
        worst_b, h_last = phases.run(
            "kernels-vs-plain", per_layer_kernels_vs_plain, torch, cfg, zoo,
            tf, params, prompts, layers)
        ref_ctx = tf.ModelContext(q_chunk=max(S, 64), kernels="ref")
        ref_logits, _ = zoo.prefill(params, cfg, ref_ctx, prompts,
                                    max_len=S + G)
    V = cfg.vocab
    e2e = rel_max(torch, step_logits[0][:, :V], ref_logits[:, :V])
    log(f"[check] (b) kernels vs plain, layer by layer on the same input: "
        f"max |update error| {worst_b:.3g} of the update's max over "
        f"{len(layers)} layers (limit {LAYER_RTOL}); last-token logits of "
        f"the whole prefill, kernels vs plain: {e2e:.3g} of max|logit| (not "
        "a gate: the random-weight 32-layer model amplifies float32 "
        "rounding; see PERF.md)")
    del ref_logits

    # (c) decode against teacher forcing, layer by layer
    seq = torch.cat([prompts, gen_toks], dim=1)             # (B, S + G)
    with torch.no_grad():
        worst_c, logit_c, steps = phases.run(
            "decode-vs-forward", per_layer_decode_vs_forward, torch, cfg, zoo,
            tf, params, seq, S, layers)
        full, _ = zoo.forward_logits(params, cfg, ctx, seq)
    served = torch.stack(step_logits, dim=1)[..., :V]        # (B, G, V)
    e2e_c = rel_max(torch, served, full[:, S - 1:S - 1 + G, :V])
    log(f"[check] (c) prefill + decode vs the no-cache forward over {S + G} "
        f"tokens, layer by layer with teacher forcing at {steps} positions "
        f"{S - 1}..{S + G - 2}"
        f": max |update error| {worst_c:.3g} (limit {LAYER_RTOL}); logits "
        f"through the last layer {logit_c:.3g} of max (limit {LOGIT_RTOL}); "
        f"the served run's logits at positions {S - 1}..{S + G - 2} vs the "
        f"forward's: {e2e_c:.3g} of max|logit| (not a gate, as in (b))")
    del full, served

    for name, rows in (("flash_attention", f_rows), ("ssd_scan", s_rows)):
        lib = sum(r.get("library_ms", 0.0) for r in rows)
        t_b = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
        t_o = sum(r["ops"] for r in rows) / FP32_OPS_PER_S * 1e3
        log(f"[kernel] {name}: {len(rows)} launches a prefill: kernel "
            f"{sum(r['ms'] for r in rows):.3f} ms, plain "
            f"{sum(r['plain_ms'] for r in rows):.3f} ms, library "
            f"{(f'{lib:.3f} ms' if name == 'flash_attention' else 'none')}, "
            f"bound {max(t_b, t_o):.3f} ms ({t_o:.3f} operations, "
            f"{t_b:.3f} bytes)")
    entries = [
        kernel_entry("flash_attention_bhsd", FLASH_SOURCE, FLASH_REPLACES,
                     launches[0], f_rows, flash_err, library=True),
        kernel_entry("ssd_scan_bh", SSD_SOURCE, SSD_REPLACES, launches[1],
                     s_rows, ssd_err, library=False),
    ]
    del params, cache, step_logits
    torch.cuda.empty_cache()
    return entries


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
    phases.run("build", build_kernels)
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
    del eng, pg, plans, kinds
    torch.cuda.empty_cache()
    serve_entries = serve_path(torch, np, args, dev, phases)
    import resource
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[device] peak device memory of the GCN path "
        f"{gcn_peak / 2**30:.2f} GiB, of the later phases "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; peak host RSS "
        f"{host_gib:.2f} GiB; phases {json.dumps(phases.seconds)}")
    # every launch of the counted algorithm runs
    entry = add_ratios({
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
    })
    # every launch of the counted GCN run: GCN_EPOCHS epochs of 4 joins
    vec_entry = add_ratios({
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
    })
    log(f"[kernel] segment_combine_blocks: {launches} launches in the "
        f"algorithm runs: kernel {entry['ms']:.3f} ms, plain "
        f"{entry['plain_ms']:.3f}, library {entry['library_ms']:.3f}, bound "
        f"{entry['bound_ms']:.3f}; {ratio_text(entry)}")
    E = GCN_EPOCHS
    log(f"[kernel] segment_combine_blocks_vec: {vec_launches} launches in "
        f"{E} epochs: kernel {vec_entry['ms']:.3f} ms ({vec_entry['ms'] / E:.3f}"
        f" an epoch), plain {vec_entry['plain_ms']:.3f} "
        f"({vec_entry['plain_ms'] / E:.3f}), library "
        f"{vec_entry['library_ms']:.3f} ({vec_entry['library_ms'] / E:.3f}), "
        f"bound {vec_entry['bound_ms']:.3f} ({vec_entry['bound_ms'] / E:.3f})"
        f"; {ratio_text(vec_entry)}")
    log(json.dumps({"kernels": [entry, vec_entry] + serve_entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
