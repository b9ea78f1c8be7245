"""The hand-written CUDA kernel for per-worker message counting, and its
wrapper.

``worker_count(worker, counts, M)`` is the (M,) int64 tally of ``counts``
by worker id behind every ``per_worker_*`` statistic (``plan.per_worker``).
It replaces no TPU kernel: the JAX package computes
``zeros(M).at[w].add(c)``, an XLA scatter.  The kernel is in
``repro_torch/csrc/worker_count.cu`` (its comments say what it computes,
what bounds it and how it is laid out), built into its own shared library
with a plain C interface by ``kernels/_build.py`` at first use.

Dispatch: a CPU tensor goes to the plain version (``ref.py``); a CUDA
tensor goes to the kernel or raises.  The tracing counter
``worker_count.launches`` (``COUNTER``; ``launches()`` reads it) counts the
calls that launched it.  The kernel reads nothing back to the host: ``M``
sizes the output and the scratch, and nothing is sized from the data.

``launch_geometry`` works out a launch's shape (ids a load, shared bytes,
blocks, the vectors a block walks) in plain Python, so the CPU tests hold
it to the card's limits; the C entry point checks it again.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.worker_count.ref import check, worker_count_ref

SOURCE = _build.CSRC / "worker_count.cu"
LIB_NAME = "worker_count"
_IDS = {torch.int32: 0, torch.int64: 1}
_COUNTS = {torch.bool: 0, torch.int32: 1, torch.int64: 2}
COUNTER = "worker_count.launches"

# Launch geometry; worker_count.cu holds the same constants.
THREADS = 256            # threads a block of the counting pass
BLOCKS_PER_SM = 4        # its resident blocks an SM, by its launch bounds
UNROLL = 4               # vector loads a thread keeps in flight
MAX_LOAD = 16            # bytes of ids a thread moves with one load
SMEM_DEFAULT = 48 * 1024     # shared bytes a block may use without opt-in
MAX_M = SMEM_DEFAULT // 8    # one 64-bit bin a worker


@dataclass(frozen=True)
class Geometry:
    """One launch's shape: ``vec`` ids (and counts) a thread loads at once,
    shared bytes a block, blocks, and ``chunk``, the vectors of ``vec``
    ids each block walks."""
    vec: int
    smem_bytes: int
    blocks: int
    chunk: int


def launch_geometry(n: int, M: int, id_bytes: int = 8, aligned: bool = True,
                    n_sm: int = 132) -> Geometry:
    """The geometry for ``n`` ids of ``id_bytes`` (and their counts) into
    ``M`` workers on a card of ``n_sm`` multiprocessors.  ``aligned`` says
    whether the ids and counts sit at addresses that allow the vector loads
    (``_aligned``); else a thread loads one id at a time.  The grid is at
    most one wave of the blocks an SM holds, and no more blocks than the
    input gives a full step of loads each."""
    if not 1 <= M <= MAX_M:
        raise ValueError(f"M={M} outside [1, {MAX_M}]: the kernel keeps one "
                         "64-bit bin a worker in 48 KB of shared memory")
    if n < 0:
        raise ValueError(f"n={n} < 0")
    vec = MAX_LOAD // id_bytes if aligned else 1
    n_vec = n // vec
    step = THREADS * UNROLL
    blocks = max(1, min(n_sm * BLOCKS_PER_SM, -(-n_vec // step)))
    return Geometry(vec, 8 * M, blocks, -(-n_vec // blocks))


def _aligned(worker: torch.Tensor, counts: torch.Tensor) -> bool:
    """Whether ``worker`` and ``counts`` allow the vector loads: 16 bytes of
    ids a load, and the counts beside them (at most 16 bytes a load)."""
    vec = MAX_LOAD // worker.element_size()
    need = min(MAX_LOAD, vec * counts.element_size())
    return (worker.data_ptr() % MAX_LOAD == 0
            and counts.data_ptr() % need == 0)


_SMS: dict = {}           # multiprocessors of each device index


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def build_library() -> dict:
    """Compile the kernel's source unless a build of it exists (see
    ``kernels/_build.py``)."""
    return _build.build_libraries([(SOURCE, LIB_NAME)])[0]


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.worker_count_launch
    # ids, counts, part, out, n, M, id_type, count_type, vec, smem_bytes,
    # blocks, chunk, device, stream
    fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i64,
                   i64, i32, ptr]
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load_library(SOURCE, LIB_NAME, _declare)


def launch(worker: torch.Tensor, counts: torch.Tensor,
           M: int) -> torch.Tensor:
    """Run the CUDA kernel on ``worker`` and ``counts``, both on one CUDA
    device; returns the (M,) int64 totals.  Raises on anything the kernel
    does not take."""
    check(worker, counts)
    if not (worker.is_cuda and counts.is_cuda
            and worker.device == counts.device):
        raise ValueError("the worker_count kernel takes tensors on one CUDA "
                         f"device, got {worker.device} and {counts.device}")
    worker = worker.reshape(-1).contiguous()
    counts = counts.reshape(-1).contiguous()
    device, n = worker.device, worker.numel()
    geo = launch_geometry(n, M, worker.element_size(),
                          _aligned(worker, counts), _sm_count(device))
    if n == 0:
        return torch.zeros(M, dtype=torch.int64, device=device)
    out = torch.empty(M, dtype=torch.int64, device=device)
    part = torch.empty((geo.blocks, M), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().worker_count_launch(
        worker.data_ptr(), counts.data_ptr(), part.data_ptr(),
        out.data_ptr(), n, M, _IDS[worker.dtype], _COUNTS[counts.dtype],
        geo.vec, geo.smem_bytes, geo.blocks, geo.chunk, device.index or 0,
        stream)
    if rc != 0:
        raise RuntimeError(f"worker_count kernel launch failed: CUDA error "
                           f"{rc} (n={n}, M={M}, {worker.dtype} ids, "
                           f"{counts.dtype} counts)")
    tracing.count(COUNTER)
    return out


def worker_count(worker: torch.Tensor, counts: torch.Tensor,
                 M: int) -> torch.Tensor:
    """(M,) int64 totals of ``counts`` (bool flags or integer counts) by
    ``worker`` id; ids outside ``[0, M)`` add nothing.  The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if worker.device.type == "cpu":
        return worker_count_ref(worker, counts, M)
    return launch(worker, counts, M)


def launches() -> int:
    """The kernel's launches in this process so far."""
    return tracing.counters().get(COUNTER, 0)
