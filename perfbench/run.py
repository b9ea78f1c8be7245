#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from anywhere; the checkout is the directory above this file.  Its last
line of standard output is the run's result as one JSON object; its last
lines of standard error are the numbers the check compared, each beside
its limit.  See ``perfbench/README.md``.
"""
import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from /proc, to
    the kernel's clock tick), so that set-up counts the interpreter's own
    start; the first line of this file where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _T0


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program builds its own kernels into ``build/repro_torch``)."""
    base = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


if __name__ == "__main__":
    t_start = min(process_start(), _T0)
    cache_dirs()
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness.main import main
    sys.exit(main(sys.argv[1:], t_start))
