#!/usr/bin/env python3
"""The control of a cell's check, and the readings its limits come from.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13

For each seed, in one process: the cell is set up as a run sets it up; one
job runs as the window runs it (the sound reading); then the control runs:
the same program with its own ``max_supersteps`` set two below the
supersteps the sound job took, so that the last superstep that changed an
answer is left out.  That is a stale answer where the configuration states
an exact one, the step that would tempt a later change.  Both are held to
the plain reference, and one JSON line a seed is printed.  The benchmark's
own runs never run this.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device) -> dict:
    """The sound job's and the control's numbers on one seed."""
    import torch
    from perfbench.harness import cell as cell_mod

    dev = torch.device(device)
    setup = {}
    ld = cell_mod.load(cell, seed, dev, setup)
    sound = ld.engine.run(ld.algo, ld.pg, **ld.params)
    steps = int(sound.n_supersteps)
    stale = dict(ld.params, max_supersteps=max(steps - 2, 0))
    control = ld.engine.run(ld.algo, ld.pg, **stale)
    answers = {0: sound.state.clone(), 1: control.state.clone()}
    del sound, control
    cell_mod.free_program(ld, dev)
    numbers = cell_mod.judge(cell, seed, dev, ld, answers)
    return {"workload": cell.name, "seed": seed, "n_supersteps": steps,
            "control_supersteps": stale["max_supersteps"],
            "sound": numbers[0], "control": numbers[1], "setup": setup}


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, read in one process")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from perfbench.harness import spec
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(cell, seed, args.device)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main(sys.argv[1:]))
