"""Train and serve step factories (the counterpart of
``repro.train.train_step``).

``make_train_step`` builds the canonical step:

    loss -> grad (each layer recomputed under ``ModelContext.remat``) ->
    clip -> AdamW -> new state

with optional gradient accumulation over microbatches: float32
accumulators, each microbatch's gradient divided by their count and added
in microbatch order (the reference's ``lax.scan`` carry), the metrics the
mean over the microbatches.

A train state is ``{"params": tree, "opt": {"master", "m", "v", "step"}}``
in the reference's layout, its dicts keyed in sorted order.  Every leaf is
its own tensor: with tied embeddings (``gemma3_4b``) ``out_embed`` starts
as a copy of ``embed`` and from then on takes its own gradient and its own
AdamW update, as the reference's two pytree leaves do (one shared tensor
would sum the two gradients).  ``abstract_train_state`` comes with the
dry-run's counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import ModelContext
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, tree_leaves,
                                         tree_map)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    opt: OptConfig = OptConfig()
    aux_weight: float = 0.01


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     device="cuda", dtype: torch.dtype = torch.float32
                     ) -> Dict[str, Any]:
    """Fresh params (``model_zoo.init_params``'s recipe, drawn from
    ``generator``) and their optimizer state; a tied ``out_embed`` becomes
    a leaf of its own."""
    params = zoo.init_params(cfg, generator, device, dtype)
    if cfg.tie_embeddings:
        params["out_embed"] = params["embed"].clone()
    return {"params": params, "opt": init_opt_state(params)}


def _grads(cfg: ArchConfig, ctx: ModelContext, step_cfg: StepConfig,
           params, batch):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``: grads a tree of
    params' structure (zeros for a leaf the loss does not reach, e.g. the
    mirrored experts' weights of a model that mirrors none, as JAX gives)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = zoo.loss_fn(p, cfg, ctx, batch,
                                aux_weight=step_cfg.aux_weight)
    leaves = tree_leaves(p)
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def take(t):
        g = next(got)
        return torch.zeros_like(t) if g is None else g
    grads = tree_map(take, p)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ArchConfig, ctx: ModelContext,
                    step_cfg: StepConfig = StepConfig()):
    """``train_step(state, batch) -> (new_state, metrics)``; ``batch``
    holds tensors on the params' device ({"tokens": (B, S) int,
    "enc_embeds": ...}); metrics: loss, nll, aux, grad_norm, lr (0-d
    tensors)."""

    def single(params, batch):
        return _grads(cfg, ctx, step_cfg, params, batch)

    def accumulated(params, batch):
        n = step_cfg.n_microbatches
        micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                 for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        losses, metrics = [], []
        for i in range(n):
            loss, m, grads = single(params, {k: v[i] for k, v in
                                             micro.items()})
            acc = tree_map(lambda a, g: a + g.to(torch.float32) / n, acc,
                           grads)
            losses.append(loss)
            metrics.append(m)
        mean = {k: torch.stack([m[k] for m in metrics]).mean()
                for k in metrics[0]}
        return torch.stack(losses).mean(), mean, acc

    def train_step(state, batch):
        fn = single if step_cfg.n_microbatches == 1 else accumulated
        loss, metrics, grads = fn(state["params"], batch)
        new_params, new_opt, opt_metrics = adamw_update(
            state["params"], grads, state["opt"], step_cfg.opt)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, ctx: ModelContext, max_len: int = 0):
    def prefill_step(params, batch):
        return zoo.prefill(params, cfg, ctx, batch["tokens"],
                           enc_embeds=batch.get("enc_embeds"),
                           max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx: ModelContext):
    def serve_step(params, token, cache):
        return zoo.decode_step(params, cfg, ctx, token, cache)
    return serve_step
