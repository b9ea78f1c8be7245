"""The hand-written CUDA flash attention kernel and its wrapper.

``flash_attention_bhsd`` is the port of the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_bhsd``.  The kernel
is ``repro_torch/csrc/flash_attention.cu`` (its comments say what it
computes, what bounds it and how it is laid out), built by
``kernels/_build.py`` at first use into ``build/repro_torch/``.

Dispatch: a CPU tensor goes to the plain version (``ref.py``); a CUDA
tensor goes to the kernel or raises.  ``flash_attention_bhsd.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = _build.CSRC / "flash_attention.cu"
LIB_NAME = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BH = 65535           # the grid's second axis


def build_library() -> dict:
    """Compile the kernel's source unless a build of it exists."""
    return _build.build_libraries([(SOURCE, LIB_NAME)])[0]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _library() -> ctypes.CDLL:
    return _build.load_library(SOURCE, LIB_NAME, _declare)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    """Raise on anything the kernel does not take; never fall back."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("the flash attention kernel takes q, k, v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the flash attention kernel takes float32 or "
                        f"bfloat16 q, k, v of one type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
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
    if not 1 <= Sq <= Sk:
        raise ValueError(f"the kernel needs 1 <= Sq <= Sk (positions from 0 "
                         f"on both sides), got Sq={Sq}, Sk={Sk}")
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0) -> torch.Tensor:
    """Run the CUDA kernel on q (BH, Sq, d) and k/v (BKV, Sk, d), all on
    one CUDA device.  Raises on anything the kernel does not take."""
    _check(q, k, v, window)
    BH, Sq, d = q.shape
    BKV, Sk, _ = k.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq,
        Sk, d, BH // BKV, _DTYPES[q.dtype], int(causal), int(window),
        d ** -0.5, q.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention_bhsd.launches += 1
    return out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q: (BH, Sq, d); k/v: (BKV, Sk, d) with BH % BKV == 0 (GQA: query row
    b reads kv row b // (BH / BKV)).  The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return launch(q, k, v, causal=causal, window=window)


flash_attention_bhsd.launches = 0
