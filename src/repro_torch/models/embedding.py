"""Token and graph-node embeddings and the softmax cross-entropy: the port
of ``repro.models.embedding``, on one device and on the training mesh.

The three token lookup methods of the reference (``gather``, ``onehot``,
``rr``: the paper's request-respond dedup) give the same values on one
device.  ``rr`` dedups the ids and fetches each distinct row once with
``index_select``; the reference's ``onehot(uniq) @ table`` is exact, so the
two agree bit for bit, and the one-hot (tokens x vocab) is never built.

On the mesh (``launch.mesh.Mesh``) the table is vocab-sharded over the
model group: ``embed_lookup_sharded`` is the request-respond channel of
§6 (each data-parallel worker dedups its own token ids, each owner
answers once per distinct id, the answers meet in one all-reduce over the
model group), and ``logits_matmul`` / ``softmax_xent`` keep the logits'
vocab axis sharded, their reductions over it scalar-sized all-reduces.
While ``record`` is a list, each sharded lookup appends its request
counts (device tensors, no host sync).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import channels
from repro_torch.models import collectives as coll

record: Optional[list] = None


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


def check_shardable(batch: int, vocab: int, mesh) -> None:
    """Raise ValueError unless ``batch`` rows split evenly over the mesh's
    data axes and ``vocab`` rows over its model axis (the reference falls
    back to a replicated lookup there, which only GSPMD's uneven
    shardings reach)."""
    if batch % mesh.data_size or vocab % mesh.model_size:
        raise ValueError(f"the mesh {mesh.shape} needs a batch divisible by "
                         f"its data size {mesh.data_size} and a vocab "
                         f"divisible by its model size {mesh.model_size}: "
                         f"batch {batch}, vocab {vocab}")


def embed_lookup_sharded(table_loc: torch.Tensor, ids_loc: torch.Tensor,
                         mesh) -> torch.Tensor:
    """The request-respond lookup on the mesh (the reference's
    ``embed_lookup_sharded``): ``table_loc`` (V / mp, D) is this rank's
    vocab rows (rows ``[m * V/mp, (m+1) * V/mp)`` on model rank m),
    ``ids_loc`` (B_loc, S) this worker's tokens.  The worker dedups its ids
    (``cap = min(T_loc, V)``: an exact bound on the distinct requests),
    each rank fills the response rows of the ids it owns (zero rows for
    the others), one all-reduce over the model group completes the (U, D)
    response table on every rank of the slice, and ``inv`` carries it back
    to the tokens.  The result is replicated over the model group, so the
    all-reduce passes its cotangent through: a rank's table gradient is
    its own rows' part of the whole gradient.  Returns (B_loc, S, D)."""
    B, S = ids_loc.shape
    v_loc, D = table_loc.shape
    V = v_loc * mesh.model_size
    flat = ids_loc.reshape(-1).long()
    cap = min(flat.shape[0], V)
    uniq, inv, n_uniq = dedup_ids(flat, cap)      # per-WORKER request set
    local = uniq - mesh.model_rank * v_loc
    owned = (local >= 0) & (local < v_loc)
    rows = table_loc.index_select(0, torch.where(owned, local, 0))
    part = torch.where(owned[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    resp = coll.psum_replicated(part, mesh.model_group)   # the responses
    if record is not None:
        record.append({"tokens": flat.shape[0], "unique": n_uniq,
                       "vocab": V, "d_model": D, "cap": cap})
    return resp.index_select(0, inv).reshape(B, S, D)


def logits_matmul(h: torch.Tensor, table: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """h: (B, S, D) -> logits (B, S, V), float32.  On a mesh ``table`` is
    this rank's vocab rows and the logits its (B, S, V / mp) columns; ``h``
    enters through ``sum_cotangents``, since each rank's columns give only
    part of its gradient."""
    if mesh is not None:
        h = coll.sum_cotangents(h, mesh.model_group)
    return torch.einsum("bsd,vd->bsv", h, table).float()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean cross-entropy over the masked rows.  logits: (..., V) float32;
    labels: (...) int; mask: (...) {0, 1}.

    On a mesh the logits are this rank's vocab columns of its data slice:
    the max and the sum of exponentials come from every shard (all-reduces
    over the model group; the max, whose gradient cancels, enters as a
    constant), the label's logit from the one shard that holds it, and the
    mean is the global one (its numerator and count summed over the data
    group).  Each sum's result is replicated, so its cotangent passes
    through: a rank's gradient is its own slice's part of the whole."""
    if mesh is None:
        V = logits.shape[-1]
        m = logits.max(dim=-1, keepdim=True).values
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        oh = torch.nn.functional.one_hot(labels.long(), V).to(logits.dtype)
        picked = (logits * oh).sum(dim=-1)
        mask = mask.to(logits.dtype)
        nll = (lse - picked) * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    v_loc = logits.shape[-1]
    group = mesh.model_group
    local = labels.long() - mesh.model_rank * v_loc
    owned = (local >= 0) & (local < v_loc)
    m = logits.max(dim=-1, keepdim=True).values
    if mesh.model_size > 1:
        m = coll.psum_replicated(m.detach(), group, dist.ReduceOp.MAX)
    lse = torch.log(coll.psum_replicated(
        torch.exp(logits - m).sum(dim=-1), group)) + m[..., 0]
    oh = torch.nn.functional.one_hot(torch.where(owned, local, 0),
                                     v_loc).to(logits.dtype)
    if mesh.model_size > 1:
        oh = oh * owned[..., None].to(logits.dtype)
    picked = coll.psum_replicated((logits * oh).sum(dim=-1), group)
    mask = mask.to(logits.dtype)
    nll = (lse - picked) * mask
    num = coll.psum_replicated(nll.sum(), mesh.data_group)
    count = coll.psum_replicated(mask.sum(), mesh.data_group)
    return num / torch.clamp(count, min=1.0)


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
