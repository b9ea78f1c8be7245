"""Collective traffic of one rank's program (the counterpart of
``repro.launch.hlo_stats``).

The reference lowers a step, compiles it and scans the optimised HLO text
for every collective op, summing the operand sizes.  A PyTorch program has
no HLO to parse: its collectives are the ``torch.distributed`` calls that
the rank makes, each of which reaches the dispatcher as a ``c10d`` op
(``c10d.allreduce_``, ``c10d.allgather_``, ``c10d._reduce_scatter_base_``,
``c10d.alltoall_base_``, ...).  ``record_collectives`` is a
``TorchDispatchMode`` that sees each of them while the program runs, on
real tensors over a real group or on ``meta`` tensors over a fake one
(``launch.dryrun``), and ``collective_bytes`` gives the reference's dict:

    {"all-gather" | "all-reduce" | "reduce-scatter" | "all-to-all" |
     "collective-permute" | "total": {"bytes", "count"}}

``bytes`` are operand bytes, as the reference counts them (the bytes each
rank injects): an all-gather counts its input block, not its gathered
output; a reduce-scatter its whole input; an all-to-all its send buffer.
A point-to-point send counts as a collective-permute; a receive, the
other end of the same transfer, is not counted again.  Each record also
keeps every operand's shape and dtype and the group's size (``ops``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op name -> (kind, the name of its input argument); an op absent
# here (a receive, a barrier, a monitored wait) is not counted
_OPS = {
    "allreduce_": ("all-reduce", "tensors"),
    "allreduce_coalesced_": ("all-reduce", "tensors"),
    "allgather_": ("all-gather", "input_tensors"),
    "_allgather_base_": ("all-gather", "input_tensor"),
    "allgather_coalesced_": ("all-gather", "input_list"),
    "allgather_into_tensor_coalesced_": ("all-gather", "inputs"),
    "reduce_scatter_": ("reduce-scatter", "input_tensors"),
    "_reduce_scatter_base_": ("reduce-scatter", "input_tensor"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "inputs"),
    "alltoall_": ("all-to-all", "input_tensors"),
    "alltoall_base_": ("all-to-all", "input"),
    "send": ("collective-permute", "tensors"),
}


@dataclasses.dataclass(frozen=True)
class Op:
    """One collective call: its kind, operand bytes, the shape and dtype
    of each operand tensor, and its group's size."""
    kind: str
    bytes: int
    shapes: tuple
    dtypes: tuple
    group_size: int


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _group_size(args, kwargs, schema) -> int:
    for i, a in enumerate(schema.arguments):
        if a.name == "process_group":
            pg = kwargs.get(a.name, args[i] if i < len(args) else None)
            if pg is None:
                return 0
            if not isinstance(pg, dist.ProcessGroup):   # as dispatched
                pg = dist.ProcessGroup.unbox(pg)
            return int(pg.size())
    return 0


class record_collectives(TorchDispatchMode):
    """``with record_collectives() as rec: ...`` appends an ``Op`` to
    ``rec.ops`` for every collective this rank calls inside the block
    (backward passes included); ``rec.stats()`` is ``collective_bytes``
    of them."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            known = _OPS.get(func._schema.name.split("::")[-1])
            if known is not None:
                kind, arg = known
                names = [a.name for a in func._schema.arguments]
                i = names.index(arg)
                ts = _tensors(kwargs.get(arg, args[i] if i < len(args)
                                         else None))
                self.ops.append(Op(
                    kind, sum(t.numel() * t.element_size() for t in ts),
                    tuple(tuple(t.shape) for t in ts),
                    tuple(str(t.dtype) for t in ts),
                    _group_size(args, kwargs, func._schema)))
        return func(*args, **kwargs)

    def stats(self) -> Dict[str, dict]:
        return collective_bytes(self.ops)


def collective_bytes(ops) -> Dict[str, dict]:
    """Per-collective-kind {bytes, count} of recorded ``Op``s, and their
    total."""
    out = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
    for op in ops:
        out[op.kind]["bytes"] += op.bytes
        out[op.kind]["count"] += 1
    out["total"] = {"bytes": sum(v["bytes"] for v in out.values()),
                    "count": sum(v["count"] for v in out.values())}
    return out
