"""Graph-node embeddings and the softmax cross-entropy (the counterpart of
the graph half of ``repro.models.embedding``; ``node_embedding_fetch``,
which rides Ch_req, comes with that slice)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the masked rows.  logits: (..., V) float32;
    labels: (...) int; mask: (...) {0, 1}."""
    V = logits.shape[-1]
    m = logits.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    oh = torch.nn.functional.one_hot(labels.long(), V).to(logits.dtype)
    picked = (logits * oh).sum(dim=-1)
    mask = mask.to(logits.dtype)
    nll = (lse - picked) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def node_embedding_init(pg, feat_dim: int, seed: int = 0,
                        scale: Optional[float] = None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Worker-sharded node-embedding table ``(M, n_loc, feat_dim)`` on
    ``pg``'s device: N(0, scale) rows for real vertices (``scale``
    defaults to ``feat_dim**-0.5``), zero rows for padding slots.  The
    rows are a function of the ORIGINAL vertex id (placed through
    ``pg.perm``), drawn with numpy as the reference draws them, so both
    packages start from the same table."""
    if scale is None:
        scale = float(feat_dim) ** -0.5
    rng = np.random.RandomState(seed)
    rows = rng.randn(pg.n, feat_dim).astype(np.float32) * scale
    tab = np.zeros((pg.n_pad, feat_dim), np.float32)
    tab[np.asarray(pg.perm)] = rows
    return torch.from_numpy(tab).to(device=pg.device, dtype=dtype).view(
        pg.M, pg.n_loc, feat_dim)
