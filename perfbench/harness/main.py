"""The command line of one run: device checks, the run, the result line.

Exits 2, printing no result, where the program's sources are missing,
where the cell is unknown, where there is no CUDA device or fewer than the
cell asks for; exits 3 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys

from perfbench.harness import spec

#: top-level module names that no run may load: JAX and the JAX package,
#: compared whole (the port's own name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result_of(run, trace: bool) -> dict:
    """The result line: metrics of the kind the run measures, the device,
    the breakdown of a traced run, and last the numbers compared."""
    cell = run.cell
    metrics = {}
    for m in cell.metrics_of("per_layer" if trace else "end_to_end"):
        value = m.reader(cell.bench).read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": run.device_kind, "count": cell.chips,
              "memory_peak_bytes": run.peak_bytes}
    out = {"correct": run_is_correct(run), "attempted": len(run.jobs),
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["check"] = {k: {"value": run.check.get(k), "limit": lim}
                    for k, lim in cell.limits.items()}
    return out


def run_is_correct(run) -> bool:
    """Every number within its limit, on at least one answer checked, and
    every job of the window halted on its own."""
    return (run.checked > 0 and run.failed == 0
            and all(k in run.check and run.check[k] <= lim
                    for k, lim in run.cell.limits.items()))


def main(argv, t_start: float) -> int:
    args = parse(argv)
    if not (spec.ROOT / "src" / "repro_torch").is_dir():
        log(f"the program's sources are missing: {spec.ROOT / 'src'}")
        return 2
    try:
        cell = spec.load_cell(args.workload)
    except KeyError as e:
        log(str(e))
        return 2
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} present")
        return 2
    from perfbench.harness import cell as cell_mod
    torch.cuda.set_device(0)
    run = cell_mod.run_cell(cell, args.seed, args.seconds,
                            bool(args.trace), "cuda", t_start)
    out = result_of(run, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: no run may load JAX or the JAX package")
        return 3
    ms = sorted(j.seconds * 1e3 for j in run.jobs)
    log(f"[perfbench] {cell.name} seed={args.seed} jobs={len(run.jobs)} "
        f"supersteps={sorted({j.n_supersteps for j in run.jobs})} "
        f"job_ms min/median/max={ms[0]:.3f}/{ms[len(ms) // 2]:.3f}/"
        f"{ms[-1]:.3f} n={run.n} arcs={run.arcs} "
        f"setup={json.dumps(run.setup)} checked={run.checked} "
        f"failed={run.failed}")
    for k, v in out["check"].items():
        log(f"check {k} = {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
    return 0
