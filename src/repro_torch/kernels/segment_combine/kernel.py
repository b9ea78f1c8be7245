"""The hand-written CUDA kernels for sender-side message combining, and
their wrappers.

``segment_combine_blocks`` is the port of the TPU kernel
``repro.kernels.segment_combine.kernel.segment_combine_blocks``: scalar
``(R, eb)`` payloads go to one kernel (``launch``), feature-blocked
``(R, eb, F)`` payloads to the other (``launch_vec``), as the TPU kernel
dispatches on ``vals.ndim == 3``.  Both kernels are in
``repro_torch/csrc/segment_combine.cu`` (its comments say what each
computes, what bounds it and how it is laid out).  The source is built
into one shared library with a plain C interface by ``kernels/_build.py``:
``nvcc`` for ``sm_90a`` at first use, never at import, into
``build/repro_torch/`` at the root of the checkout, rebuilt when the source
changes.

Dispatch: a CPU tensor goes to the plain version (``ref.py``); a CUDA tensor
goes to a kernel or raises.  ``segment_combine_blocks.launches`` counts the
scalar kernel's launches and ``segment_combine_blocks.launches_vec`` the
vector kernel's.

``launch_geometry`` works out each launch's shape (warps a block, lane
tile, features a thread, shared bytes, blocks) in plain Python, so the CPU
tests hold it to the card's limits; the C entry points check it again.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_combine.ref import (
    segment_combine_blocks_ref)

SOURCE = _build.CSRC / "segment_combine.cu"
LIB_NAME = "segment_combine"
_OPS = {"sum": 0, "min": 1, "max": 2}
_DTYPES = {torch.int32: 0, torch.float32: 1}
MAX_NB = 1024            # slots a row the kernels' shared arrays are sized for

# Launch geometry; segment_combine.cu holds the same constants and formulas.
WARPS = 8                # warps a block at most (a warp owns one row)
SCALAR_BLOCKS = 5        # blocks an SM holds at least, by the kernels'
VEC_BLOCKS = 4           # launch bounds: the grid is one wave of them
SCALAR_MAX_TILE = 128    # scalar lanes a warp loads at once (4 a thread)
VEC_MAX_TILE = 1024      # vector lanes a warp sorts at once
SMEM_DEFAULT = 48 * 1024     # shared bytes a block may use without opt-in
SMEM_MAX = 232448            # ... and with it (227 KB)
MAX_THREADS = 1024
INT_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class Geometry:
    """One launch's shape: warps a block, lanes a warp loads (scalar) or
    sorts (vector) at once, shared bytes a block, blocks, and ``vec``, the
    features a thread moves with one load (1 for the scalar kernel)."""
    warps: int
    lane_tile: int
    smem_bytes: int
    blocks: int
    vec: int = 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_geometry(R: int, eb: int, nb: int, F: Optional[int] = None,
                    align: int = 16, n_sm: int = 132) -> Geometry:
    """The scalar kernel's geometry for (R, eb) rows into nb slots, or, with
    ``F``, the vector kernel's for (R, eb, F), on a card of ``n_sm``
    multiprocessors; ``align`` is the largest power of two (at most 16)
    dividing the values' and output's addresses in bytes.

    A block holds as many warps as its shared memory allows within the
    default 48 KB (up to ``WARPS``); the grid is one wave of the blocks an
    SM holds at least, and each warp walks its rows with the grid's
    stride."""
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"nb={nb} outside [1, {MAX_NB}]")
    if F is None:
        tile = min(SCALAR_MAX_TILE, max(32, _round_up(eb, 32)))
        per_warp = 8 * _round_up(nb, 4)               # acc, group
        vec, per_sm = 1, SCALAR_BLOCKS
    else:
        tile = min(VEC_MAX_TILE, max(32, _round_up(eb, 32)))
        per_warp = 8 * _round_up(nb, 4) + 2 * tile    # end, group, perm
        # the widest load that divides F, fits the alignment and keeps a
        # warp's 32 threads busy
        vec = next(v for v in (4, 2, 1)
                   if v == 1 or (F % v == 0 and align % (4 * v) == 0
                                 and F >= 32 * v))
        per_sm = VEC_BLOCKS
    warps = max(1, min(WARPS, SMEM_DEFAULT // per_warp))
    blocks = min(-(-max(R, 1) // warps), n_sm * per_sm)
    return Geometry(warps, tile, warps * per_warp, blocks, vec)


_SMS: dict = {}           # multiprocessors of each device index


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _align(*tensors: torch.Tensor) -> int:
    """The largest power of two, at most 16, dividing every address."""
    a = 16
    for t in tensors:
        while t.data_ptr() % a:
            a //= 2
    return a


def build_library() -> dict:
    """Compile the kernels' source unless a build of it exists (see
    ``kernels/_build.py``)."""
    return _build.build_libraries([(SOURCE, LIB_NAME)])[0]


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.segment_combine_launch
    # vals, idx, out, R, eb, nb, dtype, op, warps, lane_tile, smem_bytes,
    # blocks, device, stream
    fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, i32,
                   i64, i32, ptr]
    fn.restype = ctypes.c_int
    fn = lib.segment_combine_vec_launch
    # vals, idx, out, R, eb, nb, F, dtype, op, vec, warps, lane_tile,
    # smem_bytes, blocks, device, stream
    fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, i32,
                   i32, i32, i64, i32, ptr]
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load_library(SOURCE, LIB_NAME, _declare)


def _check(vals: torch.Tensor, idx: torch.Tensor, op: str, nb: int,
           dim: int) -> None:
    """Raise on anything the kernels do not take; never fall back."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; use one of {tuple(_OPS)}")
    if not (vals.is_cuda and idx.is_cuda and vals.device == idx.device):
        raise ValueError("the segment_combine kernel takes tensors on one "
                         f"CUDA device, got {vals.device} and {idx.device}")
    if vals.dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"{vals.dtype} combines on the card come in a later slice of "
            "the port; int32 and float32 are supported")
    if vals.dtype not in _DTYPES:
        raise TypeError(f"unsupported value dtype {vals.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if vals.dim() != dim or idx.dim() != 2 or vals.shape[:2] != idx.shape:
        raise ValueError(f"vals {tuple(vals.shape)} must be {dim}-D with "
                         f"idx {tuple(idx.shape)} as its leading axes")
    if not (vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError("vals and idx must be contiguous")
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"nb={nb} outside [1, {MAX_NB}]")


def _raise_on(rc: int, what: str, vals: torch.Tensor, nb: int,
              op: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"(vals {tuple(vals.shape)}, nb={nb}, "
                           f"{vals.dtype}, {op})")


def launch(vals: torch.Tensor, idx: torch.Tensor, op: str,
           nb: int) -> torch.Tensor:
    """Run the scalar CUDA kernel on ``vals``/``idx`` (R, eb), both on one
    CUDA device.  Raises on anything the kernel does not take."""
    _check(vals, idx, op, nb, 2)
    R, eb = vals.shape
    out = torch.empty((R, nb), dtype=vals.dtype, device=vals.device)
    if R == 0:
        return out
    geo = launch_geometry(R, eb, nb, n_sm=_sm_count(vals.device))
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = _library().segment_combine_launch(
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), R, eb, nb,
        _DTYPES[vals.dtype], _OPS[op], geo.warps, geo.lane_tile,
        geo.smem_bytes, geo.blocks, vals.device.index or 0, stream)
    _raise_on(rc, "segment_combine", vals, nb, op)
    segment_combine_blocks.launches += 1
    return out


def launch_vec(vals: torch.Tensor, idx: torch.Tensor, op: str,
               nb: int) -> torch.Tensor:
    """Run the vector CUDA kernel on ``vals`` (R, eb, F) and ``idx``
    (R, eb), both on one CUDA device; returns (R, nb, F).  Raises on
    anything the kernel does not take."""
    _check(vals, idx, op, nb, 3)
    R, eb, F = vals.shape
    out = torch.empty((R, nb, F), dtype=vals.dtype, device=vals.device)
    if R == 0 or F == 0:
        return out
    geo = launch_geometry(R, eb, nb, F, _align(vals, out),
                          _sm_count(vals.device))
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = _library().segment_combine_vec_launch(
        vals.data_ptr(), idx.data_ptr(), out.data_ptr(), R, eb, nb, F,
        _DTYPES[vals.dtype], _OPS[op], geo.vec, geo.warps, geo.lane_tile,
        geo.smem_bytes, geo.blocks, vals.device.index or 0, stream)
    _raise_on(rc, "segment_combine_vec", vals, nb, op)
    segment_combine_blocks.launches_vec += 1
    return out


def segment_combine_blocks(vals: torch.Tensor, idx: torch.Tensor, op: str,
                           nb: int) -> torch.Tensor:
    """vals: (n_blocks, eb) or feature-blocked (n_blocks, eb, F), int32 or
    float32; idx: (n_blocks, eb) int32 block-local destinations, -1
    padding.  Returns the (n_blocks, nb) / (n_blocks, nb, F) combined
    blocks: a kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if vals.device.type == "cpu":
        return segment_combine_blocks_ref(vals, idx, op, nb)
    if vals.dim() == 3:
        return launch_vec(vals, idx, op, nb)
    return launch(vals, idx, op, nb)


segment_combine_blocks.launches = 0
segment_combine_blocks.launches_vec = 0
