"""The hand-written CUDA SSD chunk scan kernel and its wrapper.

``ssd_chunk_scan`` is the port of the TPU kernel
``repro.kernels.ssd_scan.kernel.ssd_scan_bh``.  It works in the model's
layout (the TPU kernel's (BH, S, P) rows are the (batch, head) pairs),
reads B and C from their group instead of broadcasting them, takes a
ragged last chunk, and returns the final state beside y.  The kernel is
``repro_torch/csrc/ssd_scan.cu`` (its comments say what it computes, what
bounds it and how it is laid out), built by ``kernels/_build.py`` at first
use into ``build/repro_torch/``.

Dispatch: a CPU tensor goes to the plain version (``ref.py``, the
recurrence); a CUDA tensor goes to the kernel or raises.
``ssd_chunk_scan.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model

SOURCE = _build.CSRC / "ssd_scan.cu"
LIB_NAME = "ssd_scan"
MAX_PN = 128             # head dim P and state dim N
MAX_CHUNK = 128


def build_library() -> dict:
    """Compile the kernel's source unless a build of it exists."""
    return _build.build_libraries([(SOURCE, LIB_NAME)])[0]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load_library(SOURCE, LIB_NAME, _declare)


def _check(x, dt, A, B, C, init_state, chunk: int) -> None:
    """Raise on anything the kernel does not take; never fall back."""
    ts = [x, dt, A, B, C] + ([] if init_state is None else [init_state])
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("the SSD scan kernel takes tensors on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the SSD scan kernel takes float32 only, got "
                        f"{[str(t.dtype) for t in ts]}")
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"x {tuple(x.shape)} must be (b, s, h, p) and B, C "
                         f"{tuple(B.shape)}, {tuple(C.shape)} (b, s, g, n)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s)
            or g < 1 or h % g):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not fit x {tuple(x.shape)} "
                         "(h must be a multiple of g)")
    if not (1 <= p <= MAX_PN and 1 <= n <= MAX_PN):
        raise ValueError(f"head dim {p} and state dim {n} must be in "
                         f"[1, {MAX_PN}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} outside [1, {MAX_CHUNK}]")
    if init_state is not None and init_state.shape != (b, h, p, n):
        raise ValueError(f"init_state {tuple(init_state.shape)} must be "
                         f"{(b, h, p, n)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the SSD scan kernel's inputs must be contiguous")


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, *, chunk: int,
           init_state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel (model layout, all float32 on one CUDA device).
    Returns y (b, s, h, p) and the final state (b, h, p, n).  Raises on
    anything the kernel does not take."""
    _check(x, dt, A, B, C, init_state, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, s, h, g, p, n, chunk,
        x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error {rc} "
                           f"(x {tuple(x.shape)}, B {tuple(B.shape)}, "
                           f"chunk={chunk})")
    ssd_chunk_scan.launches += 1
    return y, state


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt: (b, s, h) (softplus'd, > 0); A: (h,) (< 0);
    B, C: (b, s, g, n); init_state: (b, h, p, n) or None.  Returns y
    (b, s, h, p) and the final state (b, h, p, n) float32: the kernel for
    CUDA tensors, the plain version (the recurrence, which does not depend
    on ``chunk``) for CPU tensors."""
    if x.device.type == "cpu":
        return ssd_scan_ref_model(x, dt, A, B, C, init_state)
    return launch(x, dt, A, B, C, chunk=chunk, init_state=init_state)


ssd_chunk_scan.launches = 0
