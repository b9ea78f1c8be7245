"""The hand-written CUDA flash attention kernel and its wrapper.

``flash_attention_bhsd`` is the port of the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_bhsd``.  The kernel
is ``repro_torch/csrc/flash_attention.cu`` (its comments say what it
computes, what bounds it and how it is laid out), built by
``kernels/_build.py`` at first use into ``build/repro_torch/``.

Dispatch: a CPU tensor goes to the plain version (``ref.py``); a CUDA
tensor goes to the kernel or raises.  ``flash_attention_bhsd.launches``
counts the kernel's launches.

Gradients: where a gradient is wanted (grad mode on and q, k or v
requiring one), the call goes through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is that same dispatch (so a
forward launches the kernel once, as without a gradient) and whose
backward is ``ref.flash_attention_vjp``: autograd of the plain function,
recomputed one query chunk at a time.  The TPU kernel has no backward of
its own (the reference differentiates the model's plain attention), so
this backward is plain PyTorch and launches no kernel.

``check_lengths`` is the rule on the query and key lengths, in plain
Python so that the CPU tests reach it: any ``Sq`` against ``Sk`` keys
without a mask (cross-attention: a decoder's queries against an encoder's
frames), ``Sq <= Sk`` under a causal mask or a window.

``launch_geometry`` works out each launch's shape (threads, query and key
tiles, shared bytes, blocks an SM, grid) in plain Python, so the CPU tests
hold it to the card's limits.  The wrapper passes it to the C entry point,
which checks it against the kernel's own constants and refuses any other
value.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     flash_attention_vjp)

SOURCE = _build.CSRC / "flash_attention.cu"
LIB_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HALF_TYPES = (torch.bfloat16, torch.float16)

# Launch geometry; flash_attention.cu refuses a launch shape that is not its
# own.
THREADS = 128
K_TILE = 64              # keys a tile
P_STRIDE = K_TILE + 8    # float row stride of the probability tile
MAX_BH = 2 ** 31 - 1     # the grid's first axis: (BH, query tiles)
MAX_Q_TILES = 65535      # ... and its second
SMEM_MAX = 232448        # shared bytes a block may opt in to (227 KB)


@dataclass(frozen=True)
class Geometry:
    """One launch's shape: threads a block, query rows a block (16 rows of
    threads x ``rows`` each), keys a tile, shared bytes a block, blocks an
    SM by the launch bounds, and the grid (BH, query tiles)."""
    threads: int
    rows: int
    q_tile: int
    k_tile: int
    smem_bytes: int
    min_blocks: int
    grid: tuple


def launch_geometry(d: int, dtype: torch.dtype = torch.float32, BH: int = 1,
                    Sq: int = 1) -> Geometry:
    """The kernel's geometry for head dim ``d`` and ``dtype``: 8 query rows
    a thread (4 at d = 128, 2 at d = 256, so that a thread keeps 64
    outputs), 8 scores of each 64-key tile a thread; shared memory holds Q,
    one K and one V tile (rows padded to d + 4 floats), the probability
    tile (rows of 72 floats) and, for bfloat16 and float16, the staging
    tiles that the 16-byte copies land in: two (K and V in flight
    together), or one at d = 256, where two would pass ``SMEM_MAX`` and
    the K and V copies take turns in it."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {tuple(_DTYPES)}")
    rows = {128: 4, 256: 2}.get(d, 8)
    q_tile = 16 * rows
    floats = q_tile * (d + 4) + 2 * K_TILE * (d + 4) + q_tile * P_STRIDE
    stage = (staging_tiles(d) * K_TILE * d * 2
             if dtype in HALF_TYPES else 0)
    return Geometry(THREADS, rows, q_tile, K_TILE, 4 * floats + stage,
                    1 if d >= 128 else 2, (BH, -(-Sq // q_tile)))


def check_lengths(Sq: int, Sk: int, causal: bool, window: int) -> None:
    """Raise unless the kernel takes ``Sq`` queries against ``Sk`` keys
    under this mask.  Positions start at 0 on both sides.  With no mask
    (``causal=False, window=0``) every query sees all ``Sk >= 1`` keys, so
    any ``Sq >= 1`` is taken.  Under a causal mask or a window a query
    past the last key could be left with no key (a window behind it), so
    ``Sq <= Sk`` is required: then every query keeps its own position."""
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"the kernel needs Sq >= 1 and Sk >= 1, got "
                         f"Sq={Sq}, Sk={Sk}")
    if Sq > Sk and (causal or window > 0):
        raise ValueError(f"a causal or windowed call needs 1 <= Sq <= Sk "
                         f"(positions from 0 on both sides), got Sq={Sq}, "
                         f"Sk={Sk}")


def staging_tiles(d: int) -> int:
    """Staging tiles of the kernel at head dim ``d`` for a half type
    (bfloat16, float16): one at d = 256 (shared by the K and V copies),
    else two."""
    return 1 if d == 256 else 2


def build_library() -> dict:
    """Compile the kernel's source unless a build of it exists."""
    return _build.build_libraries([(SOURCE, LIB_NAME)])[0]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    # q, k, v, out; BH, Sq, Sk, d, n_rep, dtype, causal, window; scale;
    # threads, q_tile, k_tile, smem_bytes, device; stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load_library(SOURCE, LIB_NAME, _declare)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: int) -> None:
    """Raise on anything the kernel does not take; never fall back."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("the flash attention kernel takes q, k, v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the flash attention kernel takes float32, "
                        "bfloat16 or float16 q, k, v of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (BH, Sq, d) and k, v "
                         f"{tuple(k.shape)}, {tuple(v.shape)} (BKV, Sk, d)")
    BH, Sq, d = q.shape
    BKV, Sk, dk = k.shape
    if d not in HEAD_DIMS or dk != d:
        raise ValueError(f"head dim {d} (k: {dk}) not in {HEAD_DIMS}")
    if BKV < 1 or BH % BKV or BH > MAX_BH:
        raise ValueError(f"BH={BH} must be a multiple of BKV={BKV} and at "
                         f"most {MAX_BH}")
    check_lengths(Sq, Sk, causal, window)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0) -> torch.Tensor:
    """Run the CUDA kernel on q (BH, Sq, d) and k/v (BKV, Sk, d), all on
    one CUDA device.  Raises on anything the kernel does not take."""
    _check(q, k, v, causal, window)
    BH, Sq, d = q.shape
    BKV, Sk, _ = k.shape
    geo = launch_geometry(d, q.dtype, BH, Sq)
    if geo.grid[1] > MAX_Q_TILES:
        raise ValueError(f"Sq={Sq} needs more than {MAX_Q_TILES} query tiles")
    # the 16-byte copies of K and V tiles need 16-byte aligned rows
    k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (k, v))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq,
        Sk, d, BH // BKV, _DTYPES[q.dtype], int(causal), int(window),
        d ** -0.5, geo.threads, geo.q_tile, geo.k_tile, geo.smem_bytes,
        q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention_bhsd.launches += 1
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return launch(q, k, v, causal=causal, window=window)


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU), saving only
    q, k and v; backward: ``flash_attention_vjp``, the plain function's
    gradient recomputed a query chunk at a time (no kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_vjp(q, k, v, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q: (BH, Sq, d); k/v: (BKV, Sk, d) with BH % BKV == 0 (GQA: query row
    b reads kv row b // (BH / BKV)).  The kernel for CUDA tensors, the
    plain version for CPU tensors; through ``FlashAttention`` where a
    gradient is wanted, so the output is never detached from q, k, v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


flash_attention_bhsd.launches = 0
