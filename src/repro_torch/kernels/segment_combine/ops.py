"""Host-side edge packing and entry points for the segment_combine kernel
(the counterpart of ``repro.kernels.segment_combine.ops``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.segment_combine.kernel import segment_combine_blocks
from repro_torch.kernels.segment_combine.ref import segment_combine_blocks_ref


def _identity(op: str, dtype) -> np.ndarray:
    """Channel identity in the *value* dtype: int blocks keep their integer
    dtype, so vertex ids >= 2^24 survive the packing."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.asarray({"min": info.max, "max": info.min, "sum": 0}[op],
                          dtype)
    return np.asarray({"min": np.inf, "max": -np.inf, "sum": 0.0}[op], dtype)


def pack_edges(dst: np.ndarray, n_out: int, nb: int = 256,
               eb_align: int = 512):
    """Host-side, once per graph: sort edges by destination block and pad
    each block's edge list to a common multiple-of-``eb_align`` length.

    Returns (order, idx_local (n_blocks, Eb) int32 with -1 padding) where
    ``order`` permutes per-edge values into packed layout.
    """
    n_blocks = -(-n_out // nb)
    blk = dst // nb
    order = np.argsort(blk, kind="stable")
    counts = np.bincount(blk, minlength=n_blocks)
    eb = max(int(counts.max()), 1)
    eb = -(-eb // eb_align) * eb_align
    idx_local = np.full((n_blocks, eb), -1, np.int32)
    starts = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    sblk = blk[order]
    pos = np.arange(len(dst)) - starts[sblk]       # rank within block
    idx_local.reshape(-1)[sblk * eb + pos] = dst[order] - sblk * nb
    return order, idx_local


def pack_values(vals: np.ndarray, order: np.ndarray, idx_local: np.ndarray,
                op: str = "sum") -> np.ndarray:
    """Scatter per-edge values, (E,) or feature-blocked (E, F), into the
    packed (n_blocks, Eb) / (n_blocks, Eb, F) layout aligned with
    ``pack_edges``.  The packed array keeps ``vals.dtype``; padding slots
    hold the op identity for that dtype."""
    vals = np.asarray(vals)
    if vals.ndim not in (1, 2):
        raise ValueError(f"per-edge values must be (E,) or (E, F), got "
                         f"{vals.shape}")
    n_blocks, eb = idx_local.shape
    feat = vals.shape[1:]
    valid = idx_local.reshape(-1) >= 0
    out = np.full((n_blocks, eb) + feat, _identity(op, vals.dtype),
                  vals.dtype)
    out.reshape((-1,) + feat)[valid] = vals[order]
    return out


def segment_combine(packed_vals: torch.Tensor, packed_idx: torch.Tensor,
                    op: str, nb: int, n_out: int,
                    use_kernel: bool = True) -> torch.Tensor:
    """Combine packed edge messages into (n_out,) destination values, or
    (n_out, F) when ``packed_vals`` carries a feature axis."""
    fn = segment_combine_blocks if use_kernel else segment_combine_blocks_ref
    out = fn(packed_vals, packed_idx, op, nb)
    return out.reshape((-1,) + tuple(out.shape[2:]))[:n_out]


def segment_combine_rows(packed_vals: torch.Tensor, packed_idx: torch.Tensor,
                         rows: torch.Tensor, op: str, nb: int,
                         use_kernel: bool = True) -> torch.Tensor:
    """Combine only the ``rows`` subset of a packed layout, returning their
    (len(rows), nb) combined blocks.  Rows are independent, so a subset
    combines exactly as its slice of the whole-array combine."""
    fn = segment_combine_blocks if use_kernel else segment_combine_blocks_ref
    return fn(packed_vals[rows].contiguous(), packed_idx[rows].contiguous(),
              op, nb)
