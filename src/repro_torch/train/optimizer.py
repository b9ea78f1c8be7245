"""AdamW with global-norm clipping and a cosine learning rate (the
counterpart of ``repro.train.optimizer``), as plain functions on dicts of
tensors.  Parameters are updated through a float32 master copy carried in
the optimizer state, as in the reference."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


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


def _decay_mask(p: torch.Tensor) -> bool:
    return p.dim() >= 2  # no weight decay on biases / per-head vectors


def init_opt_state(params: Params) -> dict:
    """{"master": float32 copies, "m": zeros, "v": zeros, "step": 0}."""
    device = next(iter(params.values())).device
    return {
        "master": {k: p.detach().to(torch.float32).clone()
                   for k, p in params.items()},
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(grads: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))


@torch.no_grad()
def adamw_update(params: Params, grads: Params, opt: dict,
                 cfg: OptConfig) -> Tuple[Params, dict, dict]:
    """Returns (new_params, new_opt_state, metrics)."""
    gnorm = global_norm(grads)
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
    new_params, master, m, v = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m[k] = b1 * opt["m"][k] + (1 - b1) * g
        v[k] = b2 * opt["v"][k] + (1 - b2) * torch.square(g)
        update = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps)
        if _decay_mask(p):
            update = update + cfg.weight_decay * opt["master"][k]
        master[k] = opt["master"][k] - lr * update
        new_params[k] = master[k].to(p.dtype)
    new_opt = {"master": master, "m": m, "v": v, "step": step}
    return new_params, new_opt, {"grad_norm": gnorm, "lr": lr}
