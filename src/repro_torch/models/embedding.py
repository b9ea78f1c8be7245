"""Token and graph-node embeddings and the softmax cross-entropy: the port
of ``repro.models.embedding`` on one device (``embed_lookup_sharded`` comes
with the sharded executor).

The three token lookup methods of the reference (``gather``, ``onehot``,
``rr``: the paper's request-respond dedup) give the same values on one
device.  ``rr`` dedups the ids and fetches each distinct row once with
``index_select``; the reference's ``onehot(uniq) @ table`` is exact, so the
two agree bit for bit, and the one-hot (tokens x vocab) is never built.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import channels


def dedup_ids(ids: torch.Tensor, capacity: int):
    """Sort-based fixed-capacity dedup.  ids: (T,) int.  Returns (uniq
    (capacity,), inv (T,), n_uniq) with ``uniq[inv] == ids``; unused uniq
    slots hold 0.  capacity must be >= the number of distinct ids
    (capacity = min(T, vocab) always is)."""
    T = ids.shape[0]
    s, order = torch.sort(ids, stable=True)
    first = torch.ones(T, dtype=torch.bool, device=ids.device)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, dim=0) - 1               # (T,) int64
    uniq = torch.zeros(capacity, dtype=ids.dtype,
                       device=ids.device).scatter_reduce(0, rank, s, "amax")
    inv = torch.empty_like(rank)
    inv[order] = rank
    n_uniq = rank[-1] + 1 if T else torch.zeros((), dtype=rank.dtype)
    return uniq, inv, n_uniq


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, method: str = "rr",
                 rr_capacity: int = 0) -> torch.Tensor:
    """table: (V, D); ids: (...) int.  Returns (..., D)."""
    shape = ids.shape
    flat = ids.reshape(-1).long()
    V, D = table.shape
    if method == "gather":
        out = table.index_select(0, flat)
    elif method == "onehot":
        oh = torch.nn.functional.one_hot(flat, V).to(table.dtype)
        out = oh @ table
    elif method == "rr":
        cap = rr_capacity or min(flat.shape[0], V)
        uniq, inv, _ = dedup_ids(flat, cap)
        resp = table.index_select(0, uniq)       # response table (U, D)
        out = resp.index_select(0, inv)          # back to the requesters
    else:
        raise ValueError(method)
    return out.reshape(*shape, D)


def logits_matmul(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """h: (B, S, D) -> logits (B, S, V), float32."""
    return torch.einsum("bsd,vd->bsv", h, table).float()


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


def node_embedding_fetch(g, table: torch.Tensor, ids: torch.Tensor,
                         mask: torch.Tensor):
    """Sparse embedding lookup over the request-respond channel.

    ``table`` is the worker-sharded ``(M, n_loc, F)`` node table; ``ids``
    ``(M, R)`` global (padded) vertex ids each worker wants rows for.  The
    S-V access pattern of §6 with a VECTOR payload: requests are
    deduplicated per worker, the owner responds once per distinct id with
    the whole ``(F,)`` row, and the responses are carried back to the
    requests.  Returns ``((M, R, F) values, stats)``."""
    return channels.gather(g, table, ids, mask)
