"""2-layer GCN trained on one device through the gSpMM channel joins (the
counterpart of ``repro.train.gcn``, its unsharded ``axis=None`` branch).

Every neighbourhood aggregation is a gSpMM join
(:mod:`repro_torch.core.gspmm`): the (lanes, F) feature blocks ride the
same Ch_msg sender-side combining + Ch_mir mirror fan-out the analytics
algorithms use.  Forward, per layer::

    H' = act( u_mul_e_sum(A_hat, H) @ W + b )

with ``A_hat`` the symmetrically normalized adjacency
(:func:`normalize_adjacency`: D^-1/2 A D^-1/2, symmetric, so the join's
self-adjoint backward applies).  The ``@ W`` products are ``torch.matmul``
in full float32: this path sets ``torch.backends.cuda.matmul.allow_tf32``
to False (PyTorch's default), so the card's TF32 tensor cores never round
them.

The step is the reference's: the summed masked cross-entropy is
differentiated, the gradients are divided by the count of labelled rows,
clipped by their global norm, and handed to AdamW with its own clipping
disarmed.

``devices`` trains on the sharded executor (``core/exec.py``): each rank
holds its rows of the embedding, its optimizer moments and its labels,
and a replica of the dense parameters.  Its gradient contract is the
reference's:

* each rank differentiates its LOCAL masked loss sum, with no collective
  inside it: the joins' backward is itself the collective that routes
  every rank's cotangent to the rows that own it, so the embedding's
  gradient is complete on each rank;
* the dense gradients (W1, b1, W2, b2), which saw only this rank's rows,
  the label count and the loss sum are all-reduced once, after
  ``torch.autograd.grad``;
* the global-norm clip all-reduces the embedding gradient's squared norm
  only (the dense gradients are then the same on every rank).

The dense parameters stay bitwise equal on every rank.  ``pipeline``
double-buffers the sharded exchanges and acts only under ``devices``;
the embedding rows are gathered once, at the end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import EngineConfig, RunResult
from repro_torch.core import gspmm
from repro_torch.graph.structs import Graph, PartitionedGraph
from repro_torch.models.embedding import node_embedding_init
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         global_norm, init_opt_state)

Params = Dict[str, torch.Tensor]


def normalize_adjacency(g: Graph) -> Graph:
    """Symmetric GCN normalization on a symmetrized Graph:
    w'(u,v) = w(u,v) / sqrt(d(u) d(v)) with unweighted degrees — still
    symmetric, so the segment-sum joins stay self-adjoint."""
    deg = np.maximum(g.out_degrees(), 1).astype(np.float64)
    w = g.weight if g.weight is not None else np.ones(g.m, np.float32)
    wn = (w / np.sqrt(deg[g.src] * deg[g.dst])).astype(np.float32)
    return Graph(g.n, g.src, g.dst, wn)


def gcn_labels(pg: PartitionedGraph, n_classes: int, seed: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic per-vertex class labels, a function of the ORIGINAL
    vertex id (partition-independent).  Returns ``(labels, mask)`` shaped
    ``(M, n_loc)`` on ``pg``'s device; padding slots carry label 0 with
    mask False."""
    rng = np.random.RandomState(seed + 7)
    lab = rng.randint(0, n_classes, size=pg.n).astype(np.int64)
    full = np.zeros(pg.n_pad, np.int64)
    full[np.asarray(pg.perm)] = lab
    labels = torch.from_numpy(full).to(pg.device).view(pg.M, pg.n_loc)
    return labels, pg.vmask.clone()


def init_gcn_params(pg: PartitionedGraph, feat_dim: int, hidden: int,
                    n_classes: int, seed: int = 0) -> Params:
    """{emb (M, n_loc, F); W1 (F, H), b1, W2 (H, C), b2}: Glorot-ish
    scaling, drawn with numpy as the reference draws them."""
    rng = np.random.RandomState(seed)
    s1 = (2.0 / (feat_dim + hidden)) ** 0.5
    s2 = (2.0 / (hidden + n_classes)) ** 0.5
    dense = params_from_numpy({
        "W1": rng.randn(feat_dim, hidden).astype(np.float32) * s1,
        "b1": np.zeros((hidden,), np.float32),
        "W2": rng.randn(hidden, n_classes).astype(np.float32) * s2,
        "b2": np.zeros((n_classes,), np.float32),
    }, pg.device)
    return {"emb": node_embedding_init(pg, feat_dim, seed=seed), **dense}


def params_from_numpy(params: Dict[str, np.ndarray], device) -> Params:
    """GCN params as float32 tensors on ``device``, e.g. the reference's
    params (``{k: np.asarray(v)}``), so both packages start from the same
    weights."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params.items()}


def gcn_forward(pg: PartitionedGraph, params: Params,
                backend: str = "dense", use_mirroring: bool = True
                ) -> torch.Tensor:
    """Two joins, two dense layers: (M, n_loc, C) logits."""
    fj = gspmm.gspmm_join(pg, "u_mul_e_sum", backend=backend,
                          use_mirroring=use_mirroring)
    h = fj(params["emb"])
    h = torch.relu(h @ params["W1"] + params["b1"])
    h = fj(h)
    return h @ params["W2"] + params["b2"]


def _xent_sum(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax cross-entropy, SUM over rows."""
    lse = torch.logsumexp(logits, dim=-1)
    oh = torch.nn.functional.one_hot(labels, logits.shape[-1]).to(
        logits.dtype)
    picked = torch.sum(logits * oh, dim=-1)
    nll = (lse - picked) * mask.to(logits.dtype)
    return torch.sum(nll)


def _all_reduce_dense(g, count, lsum, grads: Params, dense) -> tuple:
    """One all-reduce of the label count, the loss sum and the dense
    gradients of this rank: returns the totals and the summed
    gradients."""
    flat = torch.cat([count.reshape(1), lsum.reshape(1)]
                     + [grads[k].reshape(-1) for k in dense])
    g.all_reduce(flat)
    out, off = {}, 2
    for k in dense:
        n = grads[k].numel()
        out[k] = flat[off:off + n].view_as(grads[k])
        off += n
    return flat[0], flat[1], out


def make_gcn_step(cfg: OptConfig, backend: str = "dense",
                  use_mirroring: bool = True):
    """``mk(g) -> step(params, opt, labels, mask) ->
    ((new_params, new_opt), metrics)``, the reference's contract: ``g`` a
    PartitionedGraph, or one rank's ``exec.ShardedGraph`` with this
    rank's rows of ``emb``, its moments, ``labels`` and ``mask`` (the
    gradient contract of the module's docstring)."""
    # clipping is applied here on the whole gradient; disarm
    # adamw_update's own re-clip
    inner_cfg = dataclasses.replace(cfg, clip_norm=1e30)

    def mk(g):
        sharded = getattr(g, "sharded", False)

        def step(params: Params, opt: dict, labels: torch.Tensor,
                 mask: torch.Tensor):
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            lsum = _xent_sum(gcn_forward(g, p, backend, use_mirroring),
                             labels, mask)
            grads = dict(zip(p, torch.autograd.grad(lsum, list(p.values()))))
            lsum = lsum.detach()
            count = torch.sum(mask.to(torch.float32))
            dense = [k for k in grads if k != "emb"]
            if sharded:
                count, lsum, summed = _all_reduce_dense(g, count, lsum,
                                                        grads, dense)
                grads.update(summed)
            loss = lsum / count
            grads = {k: v / count for k, v in grads.items()}
            if sharded:
                emb2 = g.all_reduce(torch.sum(torch.square(
                    grads["emb"])).reshape(1))[0]
                gnorm = torch.sqrt(emb2 + sum(torch.sum(torch.square(
                    grads[k])) for k in dense))
            else:
                gnorm = global_norm(grads)
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
            new_params, new_opt, m = adamw_update(params, grads, opt,
                                                  inner_cfg)
            return ((new_params, new_opt),
                    {"loss": loss, "grad_norm": gnorm, "lr": m["lr"]})

        return step

    return mk


def run(pg: PartitionedGraph, config: EngineConfig | None = None, *,
        feat_dim: int = 32, hidden: int = 64, n_classes: int = 8,
        epochs: int = 10, lr: float = 1e-2, seed: int = 0,
        params: Optional[Params] = None, device=None) -> RunResult:
    """GCN training under an EngineConfig: ``state`` is the trained params
    dict, ``history`` the loss trajectory, ``n_supersteps`` the epoch
    count; under ``devices`` (this rank on ``device``) ``sharded`` is the
    executor's report of the rank's run."""
    cfg = config or EngineConfig()
    info = {}
    params, losses = train_gcn(
        pg, feat_dim=feat_dim, hidden=hidden, n_classes=n_classes,
        epochs=epochs, lr=lr, seed=seed, backend=cfg.backend,
        devices=cfg.devices, use_mirroring=cfg.use_mirroring,
        pipeline=cfg.pipeline, params=params, device=device, info=info)
    return RunResult(state=params, stats={}, n_supersteps=epochs,
                     history=losses, sharded=info or None)


def _sharded_leaf(pg):
    """The placement rule of the GCN's trees: a leaf is split by rows when
    it is vertex-shaped, (M, n_loc, ...); the dense parameters and their
    moments are replicated, whatever their first dim."""
    return lambda x: x.dim() >= 2 and tuple(x.shape[:2]) == (pg.M, pg.n_loc)


def train_gcn(pg: PartitionedGraph, feat_dim: int = 32, hidden: int = 64,
              n_classes: int = 8, epochs: int = 10, lr: float = 1e-2,
              seed: int = 0, backend: str = "dense", devices=None,
              use_mirroring: bool = True, pipeline: bool = False,
              params: Optional[Params] = None, device=None,
              info: Optional[dict] = None) -> Tuple[Params, list]:
    """Full training run: ``epochs`` full-graph AdamW steps; returns
    ``(params, loss_history)``.  ``pg`` must be partitioned from a
    :func:`normalize_adjacency`'d (or at least symmetrized) graph.

    ``devices`` (an int or an ``(H, T)`` mesh) trains on the sharded
    executor over the default process group, this rank on ``device``
    (default the partition's), with ``pipeline`` double-buffering its
    exchanges; the returned params are global (the embedding gathered
    once) and the same on every rank, and ``info``, when given, receives
    the executor's report.  ``devices=None`` is the one-device path, and
    ``pipeline`` does nothing there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if params is None:
        params = init_gcn_params(pg, feat_dim, hidden, n_classes, seed)
    opt = init_opt_state(params)
    labels, mask = gcn_labels(pg, n_classes, seed)
    cfg = OptConfig(lr=lr, weight_decay=0.0, clip_norm=1.0,
                    warmup_steps=0, total_steps=max(epochs, 1),
                    min_lr_frac=1.0)
    g, sg = pg, None
    if devices is not None:
        from repro_torch.core import exec as exec_mod
        sg = exec_mod.shard(pg, devices, exec_mod.broadcast_plan_kinds(
            backend, use_mirroring), device, pipeline)
        params, opt, labels, mask = exec_mod.place_args(
            sg, (params, opt, labels, mask), _sharded_leaf(pg))
        g = sg
    step = make_gcn_step(cfg, backend, use_mirroring)(g)
    losses = []
    for _ in range(epochs):
        (params, opt), metrics = step(params, opt, labels, mask)
        losses.append(float(metrics["loss"]))   # one host read an epoch
    if sg is not None:
        params = dict(params, emb=sg.all_gather_rows(params["emb"]))
        if info is not None:
            info.update(exec_mod._info(sg, epochs))
    return params, losses
