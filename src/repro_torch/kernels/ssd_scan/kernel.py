"""The hand-written CUDA SSD chunk scan kernel and its wrapper.

``ssd_chunk_scan`` is the port of the TPU kernel
``repro.kernels.ssd_scan.kernel.ssd_scan_bh``.  It works in the model's
layout (the TPU kernel's (BH, S, P) rows are the (batch, head) pairs),
reads B and C from their group instead of broadcasting them, takes a
ragged last chunk, and returns the final state beside y.  The kernel is
``repro_torch/csrc/ssd_scan.cu`` (its comments say what it computes, what
bounds it and how it is laid out): three passes (chunk state, state
passing, chunk scan), three CUDA launches a call, built by
``kernels/_build.py`` at first use into ``build/repro_torch/``.  The
wrapper allocates the passes' scratch (the chunk states and decays).

Dispatch: a CPU tensor goes to the plain version (``ref.py``, the
recurrence); a CUDA tensor goes to the kernel or raises.
``ssd_chunk_scan.launches`` counts the wrapper's calls that launch the
kernel.

Types: the kernel reads x, B and C in their own type, float32, bfloat16
or float16 (one type for the three), and writes y in it; dt, A and the
initial state are widened to float32 by the wrapper (exact), and the
final state is float32, as in the reference, which casts every input to
float32 and writes y in x's dtype.  Where x, B and C are not of one type
the wrapper widens the three to float32 and rounds y to x's dtype once
after the kernel: the same single rounding of the same float32 sums.

Gradients: where a gradient is wanted (grad mode on and an input
requiring one), the call goes through ``SSDChunkScan``, a
``torch.autograd.Function`` whose forward is the same dispatch and whose
backward recomputes the scan through ``models.ssm.ssd_chunked`` (the
model's own chunked algorithm, at the same chunk) and differentiates it.
The TPU kernel has no backward of its own, so this backward is plain
PyTorch and launches no kernel.

``launch_geometry`` works out the passes' shapes (threads, tiles, shared
bytes, grids) in plain Python, so the CPU tests hold it to the card's
limits.  The wrapper passes it to the C entry point, which checks it
against the kernels' own constants and refuses any other value.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model

SOURCE = _build.CSRC / "ssd_scan.cu"
LIB_NAME = "ssd_scan"
MAX_PN = 128             # head dim P and state dim N
MAX_CHUNK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Launch geometry; ssd_scan.cu refuses a launch shape that is not its own.
STATE_THREADS = 256      # a block of the chunk state pass (two row halves)
THREADS = 128            # a block of the chunk scan pass
P_TILE = 64              # columns of P a block owns
PANEL = 32               # keys of one score panel of the chunk scan
PASS_THREADS = 256       # a block of the state passing pass
SMEM_MAX = 232448        # shared bytes a block may opt in to (227 KB)
GRID_X_MAX = 2 ** 31 - 1
GRID_Y_MAX = 65535


@dataclass(frozen=True)
class Geometry:
    """The three passes' shapes: threads a block of the chunk state, the
    chunk scan and the state passing pass, columns of P a block, keys a
    score panel, the chunk rounded up to 32, shared bytes of the chunk
    state and chunk scan blocks, and the grids of the three passes (blocks
    along x and y)."""
    state_threads: int
    threads: int
    pass_threads: int
    p_tile: int
    panel: int
    chunk_pad: int
    state_smem: int
    scan_smem: int
    grids: tuple


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_geometry(P: int, N: int, chunk: int, b: int = 1, h: int = 1,
                    s: int = 1) -> Geometry:
    """The passes' geometry for head dim P, state dim N and ``chunk`` at
    (b, s, h).  The chunk state block holds dt, cum, the decays, x (chunk x
    64), B (chunk x N) and the partial sums of its second half (128 x 8);
    the chunk scan block dt, cum, C^T and B^T (N x (chunk + 4)), x, S^T
    (N x 64) and one 32-key score panel, with the chunk rounded up to 32
    and N to 4."""
    if not (1 <= P <= MAX_PN and 1 <= N <= MAX_PN):
        raise ValueError(f"head dim {P} and state dim {N} must be in "
                         f"[1, {MAX_PN}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} outside [1, {MAX_CHUNK}]")
    qp, n4 = _round_up(chunk, 32), _round_up(N, 4)
    state = 3 * qp + qp * P_TILE + qp * n4 + 8 * THREADS
    scan = (2 * qp + 2 * n4 * (qp + 4) + qp * P_TILE + n4 * P_TILE
            + PANEL * (qp + 4))
    blocks = b * h * -(-s // chunk)
    p_tiles = -(-P // P_TILE)
    grids = ((blocks, p_tiles), (-(-b * h * P * N // PASS_THREADS), 1),
             (blocks, p_tiles))
    return Geometry(STATE_THREADS, THREADS, PASS_THREADS, P_TILE, PANEL, qp,
                    4 * state, 4 * scan, grids)


def build_library() -> dict:
    """Compile the kernel's source unless a build of it exists."""
    return _build.build_libraries([(SOURCE, LIB_NAME)])[0]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_launch
    # x, dt, A, B, C, init_state, y, state_out, chunk_states, chunk_decay;
    # b, S, H, G, P, N, Q, dtype; state_threads, scan_threads,
    # pass_threads, p_tile, state_smem, scan_smem; device; stream
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + [
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
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("the SSD scan kernel takes x, B and C of one type, "
                        f"one of {tuple(_DTYPES)}, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    rest = [dt, A] + ([] if init_state is None else [init_state])
    if any(t.dtype != torch.float32 for t in rest):
        raise TypeError("the SSD scan kernel takes dt, A and init_state in "
                        f"float32, got {[str(t.dtype) for t in rest]}")
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
    if b * h * -(-s // chunk) > GRID_X_MAX:
        raise ValueError(f"{b * h} (batch, head) pairs x {-(-s // chunk)} "
                         f"chunks exceed the grid's {GRID_X_MAX} blocks")
    if init_state is not None and init_state.shape != (b, h, p, n):
        raise ValueError(f"init_state {tuple(init_state.shape)} must be "
                         f"{(b, h, p, n)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the SSD scan kernel's inputs must be contiguous")


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, *, chunk: int,
           init_state: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel (model layout, on one CUDA device: x, B and C of
    one type among float32, bfloat16 and float16, dt, A and init_state
    float32).  Returns y (b, s, h, p) in x's type and the final state
    (b, h, p, n) float32.  Raises on anything the kernel does not take."""
    _check(x, dt, A, B, C, init_state, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    geo = launch_geometry(p, n, chunk)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    n_chunks = -(-s // chunk)
    chunk_states = torch.empty((b, h, n_chunks, p, n), dtype=torch.float32,
                               device=x.device)
    chunk_decay = torch.empty((b, h, n_chunks), dtype=torch.float32,
                              device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), chunk_states.data_ptr() or None,
        chunk_decay.data_ptr() or None, b, s, h, g, p, n, chunk,
        _DTYPES[x.dtype], geo.state_threads, geo.threads, geo.pass_threads,
        geo.p_tile, geo.state_smem, geo.scan_smem, x.device.index or 0,
        stream)
    if rc != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error {rc} "
                           f"(x {tuple(x.shape)}, B {tuple(B.shape)}, "
                           f"chunk={chunk})")
    ssd_chunk_scan.launches += 1
    return y, state


def _forward(x, dt, A, B, C, init_state, chunk: int):
    """The kernel for CUDA tensors (dt, A, init_state widened to float32;
    x, B, C widened too unless they share a type, y then rounded to x's
    dtype), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return ssd_scan_ref_model(x, dt, A, B, C, init_state)
    f32 = torch.float32
    dt, A = dt.to(f32), A.to(f32)
    if init_state is not None:
        init_state = init_state.to(f32)
    if B.dtype == x.dtype and C.dtype == x.dtype:
        return launch(x, dt, A, B, C, chunk=chunk, init_state=init_state)
    y, state = launch(x.to(f32), dt, A, B.to(f32), C.to(f32), chunk=chunk,
                      init_state=init_state)
    return y.to(x.dtype), state


class SSDChunkScan(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain recurrence (CPU), saving the
    inputs; backward: autograd of ``models.ssm.ssd_chunked`` at the same
    chunk (one chunk of s when ``chunk`` does not divide s, the same
    function), recomputed from the saved inputs (no kernel).  The final
    state's gradient may be None (training never reads it)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, init_state, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        from repro_torch.models.ssm import ssd_chunked
        saved = ctx.saved_tensors
        want = [i for i, t in enumerate(saved)
                if t is not None and ctx.needs_input_grad[i]]
        grads = [None] * 7
        if not want or (dy is None and dstate is None):
            return tuple(grads)
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(
                i in want) for i, t in enumerate(saved)]
            s = ins[0].shape[1]
            chunk = ctx.chunk if s % ctx.chunk == 0 else s
            y, state = ssd_chunked(*ins[:5], chunk, init_state=ins[5])
            outs, cots = zip(*[(o, g) for o, g in ((y, dy), (state, dstate))
                               if g is not None])
            got = torch.autograd.grad(outs, [ins[i] for i in want], cots,
                                      allow_unused=True)
        for i, g in zip(want, got):   # C is unused when only dstate is given
            grads[i] = torch.zeros_like(saved[i]) if g is None else g
        return tuple(grads)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt: (b, s, h) (softplus'd, > 0); A: (h,) (< 0);
    B, C: (b, s, g, n); init_state: (b, h, p, n) or None.  Returns y
    (b, s, h, p) in x's dtype and the final state (b, h, p, n) float32:
    the kernel for CUDA tensors, the plain version (the recurrence, which
    does not depend on ``chunk``) for CPU tensors; through
    ``SSDChunkScan`` where a gradient is wanted, so the outputs are never
    detached from the inputs."""
    ts = (x, dt, A, B, C) + (() if init_state is None else (init_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return SSDChunkScan.apply(x, dt, A, B, C, init_state, chunk)
    return _forward(x, dt, A, B, C, init_state, chunk)


ssd_chunk_scan.launches = 0
