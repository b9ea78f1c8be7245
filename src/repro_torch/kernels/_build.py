"""Build and load the port's hand-written CUDA kernels.

Every kernel source under ``repro_torch/csrc/`` has a plain C interface.
It is compiled with ``nvcc`` for ``sm_90a`` into its own shared library at
first use, never at import, into ``build/repro_torch/`` at the root of the
checkout, and loaded with ``ctypes``.  A library's file name carries a
digest of its source and the flags, so a changed source is rebuilt and an
unchanged one is reused.  ``build_libraries`` starts one ``nvcc`` for each
source that needs a build, all at once, and waits for them together.

Spans (``repro_torch.tracing``): the set-up spans ``kernels.build`` (the
nvcc runs of one ``build_libraries``) and ``kernels.load`` (a library's
first load, its build included).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(src: Path, name: str) -> Path:
    """Where the build of ``src`` with these flags lives."""
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_libraries(specs: Sequence[Tuple[Path, str]]) -> List[dict]:
    """Compile each ``(source, library name)`` unless a build of that exact
    source and these flags exists; the nvcc processes run in parallel.
    Returns one ``{"name", "path", "seconds", "built", "log"}`` per spec
    (``log`` is nvcc's ``-Xptxas -v`` report of registers and shared
    memory; empty when nothing was built)."""
    out, todo = [], []
    for src, name in specs:
        path = library_path(src, name)
        info = {"name": name, "path": path, "seconds": 0.0, "built": False,
                "log": ""}
        out.append(info)
        if not path.exists():
            todo.append((info, src))
    if todo:
        with tracing.setup_span("kernels.build",
                                names=[i["name"] for i, _ in todo]):
            _run_nvcc(todo)
    return out


def _run_nvcc(todo: List[Tuple[dict, Path]]) -> None:
    """One nvcc for each ``(info, source)``, all at once; each library is
    moved into place as it finishes."""
    running = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for info, src in todo:
        path = info["path"]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((info, src, tmp, proc, time.perf_counter()))
    failed = []
    for info, src, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
            continue
        os.replace(tmp, info["path"])   # atomic: no reader sees half a file
        info.update(seconds=time.perf_counter() - t0, built=True, log=log)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(src: Path, name: str,
                 declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``src`` (built first if needed); ``declare``
    sets the ``argtypes`` and ``restype`` of its C functions once."""
    lib = _loaded.get(name)
    if lib is None:
        with tracing.setup_span("kernels.load", name=name):
            lib = ctypes.CDLL(str(build_libraries([(src, name)])[0]["path"]))
            declare(lib)
        _loaded[name] = lib
    return lib
