"""Plain PyTorch version of the segment_combine kernel.

Same blocked layout and output contract as the CUDA kernels
(``kernel.py``): for packed ``(n_blocks, eb)`` values and block-local
indices, ``out[r, n]`` is the op over the lanes ``e`` of row ``r`` with
``idx[r, e] == n``; lanes whose index is outside ``[0, nb)`` (the ``-1``
padding) never hit.  Feature-blocked ``(n_blocks, eb, F)`` values give
``(n_blocks, nb, F)``: every feature combines on its own, through the same
indices (features never mix).  Slots that no lane hits hold the op's
identity in the *kernel's* convention: 0 for sum, ``sentinels(dtype)`` for
min/max.  Sums accumulate in float32 (int32, wrapping, for integers) and
are stored in the input dtype.  CPU tensors always take this path;
``chip_smoke.py`` and the tests hold the kernels against it on the card.
"""
from __future__ import annotations

import torch

NEG = -3.0e38
POS = 3.0e38


def sentinels(dtype: torch.dtype):
    """(min-identity, max-identity) used inside the combine blocks.

    Integers use their iinfo bounds, which are also the channels'
    identities.  Floats use the finite sentinels NEG/POS (the plan layer
    maps them back to -inf/+inf), except floats narrower than float32 that
    cannot hold 3e38 (float16), which use their own finfo bounds.
    """
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return info.min, info.max
    info = torch.finfo(dtype)
    if float(info.max) < POS:
        return float(info.min), float(info.max)
    return NEG, POS


def block_identity(op: str, dtype: torch.dtype):
    """The value a slot that no lane hits holds, for ``op`` and ``dtype``."""
    neg, pos = sentinels(dtype)
    return {"sum": 0, "min": pos, "max": neg}[op]


def segment_combine_blocks_ref(vals: torch.Tensor, idx: torch.Tensor,
                               op: str, nb: int) -> torch.Tensor:
    """vals: (n_blocks, eb) or (n_blocks, eb, F); idx: (n_blocks, eb) int
    -> (n_blocks, nb) or (n_blocks, nb, F)."""
    if op not in ("sum", "min", "max"):
        raise ValueError(f"unknown op {op!r}; use sum, min or max")
    if vals.dim() not in (2, 3) or vals.shape[:2] != idx.shape:
        raise ValueError(f"vals {tuple(vals.shape)} must be idx "
                         f"{tuple(idx.shape)} with at most one trailing "
                         "feature axis")
    R, eb = idx.shape
    feat = tuple(vals.shape[2:])
    hit = (idx >= 0) & (idx < nb)
    lane_hit = hit.view(R, eb, *([1] * len(feat)))
    rows = torch.arange(R, device=idx.device).unsqueeze(1) * nb
    flat = (rows + torch.where(hit, idx, 0).long()).reshape(-1)
    if op == "sum":
        acc = torch.float32 if vals.dtype.is_floating_point else torch.int32
        v = torch.where(lane_hit, vals.to(acc), 0).reshape((-1,) + feat)
        out = torch.zeros((R * nb,) + feat, dtype=acc, device=vals.device)
        out.index_add_(0, flat, v)
        return out.to(vals.dtype).view((R, nb) + feat)
    ident = block_identity(op, vals.dtype)
    v = torch.where(lane_hit, vals, ident).reshape((-1,) + feat)
    out = torch.full((R * nb,) + feat, ident, dtype=vals.dtype,
                     device=vals.device)
    if feat:
        flat = flat.view(-1, 1).expand_as(v)
    out.scatter_reduce_(0, flat, v, "amin" if op == "min" else "amax")
    return out.view((R, nb) + feat)
