"""gSpMM as a channel join (the counterpart of ``repro.core.gspmm``):
generalized sparse-dense aggregation on the BSP engine's message channels,
with feature-blocked (lanes, F) payloads.

The three DGL-style generalized SpMM primitives are ONE
``channels.broadcast`` join each, the same Ch_msg (sender-side combined)
+ Ch_mir (mirror fan-out) pipeline every algorithm rides:

    copy_u_sum :  out[v] = sum_{(u,v) in E}  x[u]
    u_mul_e_sum:  out[v] = sum_{(u,v) in E}  x[u] * w(u,v)
    u_mul_e_max:  out[v] = max_{(u,v) in E}  x[u] * w(u,v)

``x`` is the (M, n_loc, F) vertex-feature state; the edge weight
broadcasts over the feature axis (``relay="mul_w"``).

Differentiation: the sum joins are a ``torch.autograd.Function``.  On the
symmetrized graphs the engine operates on (every edge stored in both
directions, w(u,v) = w(v,u)), the adjoint of the weighted segment-sum is
the SAME weighted broadcast applied to the cotangent:

    d/dx [ sum_v <g[v], out[v]> ]  =  A^T (W * g)  =  A (W * g)

so the backward pass is one more channel join, and the function saves no
tensors.  On one rank's ``exec.ShardedGraph`` the join is sharded: the
backward join issues the same collectives as the forward, so every rank's
cotangent reaches the rows that own it (the gradient of each rank's rows
is complete without an all-reduce).  ``u_mul_e_max`` is forward-only: its
output carries no gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import channels

GSPMM_KINDS = ("copy_u_sum", "u_mul_e_sum", "u_mul_e_max")

_KIND = {
    "copy_u_sum": ("sum", "none"),
    "u_mul_e_sum": ("sum", "mul_w"),
    "u_mul_e_max": ("max", "mul_w"),
}


def _join(g, op: str, relay: str, backend: str, use_mirroring: bool,
          count: bool) -> Callable:
    """The raw (non-differentiable) channel join: feats -> (out, stats)."""
    def apply(feats: torch.Tensor):
        active = torch.ones(feats.shape[:2], dtype=torch.bool,
                            device=feats.device)
        return channels.broadcast(g, feats, active, op, relay=relay,
                                  use_mirroring=use_mirroring,
                                  backend=backend, count=count)
    return apply


class _SelfAdjointJoin(torch.autograd.Function):
    """out = join(feats); d feats = join(d out).  Saves no tensors."""

    @staticmethod
    def forward(ctx, feats, apply):
        ctx.join = apply
        return apply(feats)[0].contiguous()

    @staticmethod
    def backward(ctx, gout):
        return ctx.join(gout.contiguous())[0].contiguous(), None


def gspmm_join(g, kind: str, backend: str = "dense",
               use_mirroring: bool = True) -> Callable:
    """The differentiable gSpMM aggregation on the PartitionedGraph ``g``
    (or one rank's ShardedGraph): ``fn(feats) -> out`` with feats/out
    (M, n_loc, F) (the rank's (m_loc, n_loc, F) rows).  The join skips the
    message accounting, which the reference computes and drops; call
    :func:`gspmm_stats` for it.  The sum kinds back-propagate through one
    more join of the cotangent (the symmetrized edge set makes the join
    self-adjoint); ``u_mul_e_max`` is forward-only."""
    if kind not in GSPMM_KINDS:
        raise ValueError(f"unknown gSpMM kind {kind!r}; "
                         f"use one of {GSPMM_KINDS}")
    op, relay = _KIND[kind]
    apply = _join(g, op, relay, backend, use_mirroring, count=False)

    if op != "sum":
        def fwd_only(feats):
            with torch.no_grad():
                out, _ = apply(feats)
            # empty inboxes hold the max identity (-inf); zero-fill like
            # the dense segment-max convention so downstream dense math
            # never sees non-finite values
            return torch.where(torch.isinf(out), 0.0, out)
        return fwd_only

    return lambda feats: _SelfAdjointJoin.apply(feats, apply)


def gspmm_stats(g, kind: str, feats: torch.Tensor, backend: str = "dense",
                use_mirroring: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the join once returning ``(out, stats)``: the message
    accounting (msgs_combined / msgs_mirror / per-worker loads) of the
    aggregation, identical to any other channel join's stats."""
    op, relay = _KIND[kind]
    return _join(g, op, relay, backend, use_mirroring, count=True)(feats)


def copy_u_sum(g, feats, backend: str = "dense"):
    """out[v] = sum of neighbour features (differentiable)."""
    return gspmm_join(g, "copy_u_sum", backend)(feats)


def u_mul_e_sum(g, feats, backend: str = "dense"):
    """out[v] = weighted sum of neighbour features (differentiable)."""
    return gspmm_join(g, "u_mul_e_sum", backend)(feats)


def u_mul_e_max(g, feats, backend: str = "dense"):
    """out[v] = weighted max over neighbour features (forward-only;
    empty inboxes are zero-filled)."""
    return gspmm_join(g, "u_mul_e_max", backend)(feats)


def gspmm_sharded(pg, kind: str, feats, devices=1, backend: str = "dense",
                  pipeline: bool = False, use_mirroring: bool = True,
                  device=None):
    """One-shot sharded gSpMM over the ranks of the default process group
    (``devices`` an int or a ``(hosts, per_host)`` pair; ``device`` this
    rank's, default the partition's): ``feats`` is the global (M, n_loc,
    F) state, split by rows.  Returns ``(out, stats)``: ``out`` (M,
    n_loc, F) gathered in rank order, ``stats`` summed over the ranks.
    Max bitwise equal to one device, sums to round-off, stats exact."""
    from repro_torch.core import exec as exec_mod

    def mk(g):
        return lambda x: gspmm_stats(g, kind, x, backend=backend,
                                     use_mirroring=use_mirroring)
    out, stats, _ = exec_mod.apply_sharded(
        pg, mk, (feats,), devices=devices,
        plan_kinds=exec_mod.broadcast_plan_kinds(backend, use_mirroring),
        device=device, pipeline=pipeline)
    return out, stats
