"""AdamW with global-norm clipping and a cosine learning rate (the
counterpart of ``repro.train.optimizer``), as plain functions on trees of
tensors: dicts, lists and tuples nested to any depth (the GCN's flat dict,
the LM's params with their stacked per-stage leaves).  Leaves are walked
in each dict's own key order and each sequence's order; the LM trees that
``models.model_zoo`` builds and ``train.checkpoint`` restores keep their
dict keys sorted, ``jax.tree``'s order.  Parameters are updated through a
float32 master copy carried in the optimizer state, as in the
reference."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac * lr``."""
    step = step.to(torch.float32)
    warm = cfg.lr * (step + 1.0) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = (cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr
           * 0.5 * (1.0 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, leaf by leaf; the result has ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in the walk's order."""
    out = []
    tree_map(out.append, tree)
    return out


def _decay_mask(p: torch.Tensor) -> bool:
    return p.dim() >= 2  # no weight decay on biases / per-head vectors


def init_opt_state(params: Params) -> dict:
    """{"master": float32 copies, "m": zeros, "v": zeros, "step": 0}, each
    a tree of ``params``' structure."""
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32).clone(),
                           params),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def abstract_opt_state(params: Params) -> dict:
    """``init_opt_state``'s tree on the ``meta`` device: float32 master, m
    and v of ``params``' shapes, an int32 step."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"master": tree_map(f32, params), "m": tree_map(f32, params),
            "v": tree_map(f32, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(grads: Params, sum_squares=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (float32), summed in
    the walk's order.  ``sum_squares``, if given, maps the list of the
    leaves' sums of squares to the list to add up (the mesh trainer sums a
    vocab shard's over the model group there)."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree_leaves(grads)]
    if sum_squares is not None:
        sq = sum_squares(sq)
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(params: Params, grads: Params, opt: dict,
                 cfg: OptConfig, sum_squares=None
                 ) -> Tuple[Params, dict, dict]:
    """Returns (new_params, new_opt_state, metrics); the new trees have
    ``params``' structure.  ``sum_squares``: ``global_norm``'s."""
    gnorm = global_norm(grads, sum_squares)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, master, m, v):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if _decay_mask(p):
            update = update + cfg.weight_decay * master
        new_master = master - lr * update
        return new_master.to(p.dtype), new_master, m2, v2

    out = tree_map(upd, params, grads, opt["master"], opt["m"], opt["v"])

    def part(i):
        return tree_map(lambda p, o: o[i], params, out)
    new_opt = {"master": part(1), "m": part(2), "v": part(3), "step": step}
    return part(0), new_opt, {"grad_norm": gnorm, "lr": lr}
