"""Collectives with the gradients of an SPMD program (the counterparts of
``lax.psum``, ``lax.all_to_all`` and the reshards that ``shard_map``'s
specs imply), as ``torch.autograd.Function``s over a process group.

Every rank runs the same program; a value is either *replicated* over a
group (every rank holds the same tensor, and its cotangent, the same on
every rank, is the whole cotangent of that one value) or *split* (each
rank holds its own part).  The backward of each collective follows from
which it makes:

* ``psum_replicated``: a sum whose result is replicated.  Each rank's
  part enters the sum once, so its cotangent is the result's, unchanged:
  the backward sends nothing.  (``torch.distributed.nn.functional``'s
  all-reduce sums the cotangents again, which gives the group's size
  times the gradient.)
* ``sum_cotangents``: the identity on a replicated value that each rank
  then uses on its own part of the work (a vocab shard of the logits):
  the backward sums the ranks' partial cotangents over the group.
* ``all_to_all``: equal splits exchanged; its transpose is the same
  exchange.
* ``gather_slices`` / ``split_slices``: split rows made replicated (all
  ranks' slices concatenated; the backward keeps this rank's slice of the
  cotangent) and a replicated value split (this rank's slice; the
  backward concatenates every rank's slice of the cotangent).
  Along another dimension ``gather_slices`` makes a tensor-parallel
  rank's head block whole (the decode step's new query, key and value,
  the prefill's cache heads).

A sum whose replicated result each rank then uses for its own shard only
(the gated norm's sum of squares over a split d_inner) is
``sum_cotangents(psum_replicated(x))``: both directions sum.

A leaf that fsdp splits over the data group (``DataBlock``: this rank's
block, the split dimension) is made whole where it is used by
``gather_data``, whose backward gives each rank the sum over the group of
its own block of the cotangent, a reduce-scatter: each rank's cotangent is
its own data slice's part of the whole.  A stacked leaf split on its
layer axis holds each layer whole on one rank (its owner): that layer is
made whole by a masked all-reduce (the owner's values, zeros elsewhere),
whose backward is the same all-reduce of the cotangent, kept by the
owner.  ``reduce_scatter`` and ``all_gather`` are the plain collectives of
ZeRO-1's gradient and parameter exchange.

On a group of one rank each is the identity, and none is called.  Values
are those of the plain ``torch.distributed`` calls, so a forward under
``torch.no_grad`` is unchanged.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """A process group's size (1 for None: no group, one rank)."""
    return 1 if group is None else dist.get_world_size(group)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        y = x.clone()
        dist.all_reduce(y, op=op, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumCotangents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def _all_gather_cat(x, group, dim=0):
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return _all_gather_cat(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.width, ctx.width), None, None


class _SplitSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = group_size(group)
        rows = x.shape[0] // n
        r = dist.get_rank(group)
        return x[r * rows:(r + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g.contiguous(), ctx.group), None


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) summed over ``group``, this rank's
    block of the sum along ``dim`` returned (``dim`` a multiple of the
    group's size)."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's block ``x`` (equal shapes) concatenated along ``dim``
    in the group's rank order."""
    if group_size(group) == 1:
        return x
    return _all_gather_cat(x.contiguous(), group, dim)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, owner):
        ctx.group, ctx.dim, ctx.owner = group, dim, owner
        if dim is not None:
            return all_gather(x, group, dim)
        mine = dist.get_rank(group) == owner
        y = x.clone() if mine else torch.zeros_like(x)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is not None:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        mine = dist.get_rank(ctx.group) == ctx.owner
        return (g if mine else None), None, None, None


def gather_data(x: torch.Tensor, group, dim=None,
                owner: int = 0) -> torch.Tensor:
    """The whole value of a leaf split over ``group``, differentiable:
    ``x`` is this rank's block along ``dim``, or (``dim`` None) the whole
    value on the group's rank ``owner`` and a stand-in of its shape and
    dtype on the others.  The backward gives each rank the sum over the
    group of its block of the cotangent (none to a stand-in)."""
    if group_size(group) == 1:
        return x
    return _GatherData.apply(x, group, dim, owner)


class DataBlock:
    """A leaf that fsdp holds split over the data group: ``t``, this
    rank's block along dimension ``dim`` (None: ``t`` is the whole value
    on the group's rank ``owner``, a stand-in elsewhere).  ``whole()``
    gathers it (``gather_data``); ``layer(i)`` is layer i of a stacked
    leaf, which a split on the layer axis leaves whole on one rank."""

    __slots__ = ("t", "group", "dim", "owner")

    def __init__(self, t, group, dim, owner=0):
        self.t, self.group, self.dim, self.owner = t, group, dim, owner

    def layer(self, i: int) -> "DataBlock":
        if self.dim == 0:
            n = self.t.shape[0]
            return DataBlock(self.t[i % n], self.group, None, i // n)
        return DataBlock(self.t[i], self.group, self.dim - 1)

    def whole(self) -> torch.Tensor:
        return gather_data(self.t, self.group, self.dim, self.owner)


def whole(x):
    """``x`` made whole where it is a ``DataBlock``, else ``x``."""
    return x.whole() if isinstance(x, DataBlock) else x


def psum_replicated(x: torch.Tensor, group,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce over ``group`` (``op``, a sum by default), the result
    replicated: the backward passes the cotangent through."""
    if group_size(group) == 1:
        return x
    return _PsumReplicated.apply(x, group, op)


def sum_cotangents(x: torch.Tensor, group) -> torch.Tensor:
    """The identity forward; the backward sums the cotangent over
    ``group``."""
    if group_size(group) == 1:
        return x
    return _SumCotangents.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal splits over ``group`` (the leading
    dimension in ``group``'s size parts), differentiable."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def gather_slices(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal sizes) concatenated along ``dim`` in rank
    order, replicated; the backward keeps this rank's block.  Along the
    heads axis it makes a tensor-parallel rank's head block whole."""
    if group_size(group) == 1:
        return x
    return _GatherSlices.apply(x, group, dim)


def split_slices(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of the replicated ``x``'s rows (a multiple of
    ``group``'s size); the backward gathers every rank's slice of the
    cotangent."""
    if group_size(group) == 1:
        return x
    return _SplitSlices.apply(x, group)
