"""The hand-written CUDA kernel for sender-side message combining, and its
wrapper.

``segment_combine_blocks`` is the port of the TPU kernel
``repro.kernels.segment_combine.kernel.segment_combine_blocks`` (scalar
payloads).  The kernel is ``repro_torch/csrc/segment_combine.cu`` (its
header says what it computes, what bounds it and how it is laid out).  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, never at import, into ``build/repro_torch/`` at the
root of the checkout, and rebuilt when the source changes.

Dispatch: a CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
goes to the kernel or raises.  ``segment_combine_blocks.launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.segment_combine.ref import (
    segment_combine_blocks_ref)

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "segment_combine.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_OPS = {"sum": 0, "min": 1, "max": 2}
_DTYPES = {torch.int32: 0, torch.float32: 1}
MAX_NB = 1024            # one thread per output slot of a row

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the segment_combine kernel")


def build_library() -> dict:
    """Compile the kernel's source into a shared library unless a build of
    this exact source and these flags exists.  Returns ``{"path",
    "seconds", "built", "log"}`` (``log`` is nvcc's ``-Xptxas -v`` report
    of registers and shared memory; empty when nothing was built)."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f"segment_combine-{digest}.so"
    if path.exists():
        return {"path": path, "seconds": 0.0, "built": False, "log": ""}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {_SRC}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)     # atomic: a concurrent build never sees half
    return {"path": path, "seconds": time.perf_counter() - t0,
            "built": True, "log": proc.stdout + proc.stderr}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()["path"]))
        fn = lib.segment_combine_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(vals: torch.Tensor, idx: torch.Tensor, op: str,
           nb: int) -> torch.Tensor:
    """Run the CUDA kernel on ``vals``/``idx`` (both on one CUDA device).
    Raises on anything the kernel does not take; never falls back."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; use one of {tuple(_OPS)}")
    if not (vals.is_cuda and idx.is_cuda and vals.device == idx.device):
        raise ValueError("the segment_combine kernel takes tensors on one "
                         f"CUDA device, got {vals.device} and {idx.device}")
    if vals.dim() == 3:
        raise NotImplementedError(
            "feature-blocked (n_blocks, eb, F) payloads need the vector "
            "kernel, which a later slice of the port adds")
    if vals.dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"{vals.dtype} combines on the card come in a later slice of "
            "the port; int32 and float32 are supported")
    if vals.dtype not in _DTYPES:
        raise TypeError(f"unsupported value dtype {vals.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if vals.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and idx "
                         f"{tuple(idx.shape)} must be the same 2-D shape")
    if not (vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError("vals and idx must be contiguous")
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"nb={nb} outside [1, {MAX_NB}]")
    R, eb = vals.shape
    out = torch.empty((R, nb), dtype=vals.dtype, device=vals.device)
    if R == 0:
        return out
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = _library().segment_combine_launch(
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), R, eb, nb,
        _DTYPES[vals.dtype], _OPS[op], vals.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"segment_combine kernel launch failed: CUDA "
                           f"error {rc} (R={R}, eb={eb}, nb={nb}, "
                           f"{vals.dtype}, {op})")
    segment_combine_blocks.launches += 1
    return out


def segment_combine_blocks(vals: torch.Tensor, idx: torch.Tensor, op: str,
                           nb: int) -> torch.Tensor:
    """vals: (n_blocks, eb) int32/float32; idx: (n_blocks, eb) int32
    block-local destinations, -1 padding.  Returns the (n_blocks, nb)
    combined blocks: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if vals.device.type == "cpu":
        return segment_combine_blocks_ref(vals, idx, op, nb)
    return launch(vals, idx, op, nb)


segment_combine_blocks.launches = 0
