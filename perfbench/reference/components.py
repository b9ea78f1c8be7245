"""Connected components in plain PyTorch, and the comparison of a
program's component labels with them.

``min_labels`` is hooking and pointer jumping on a parent array: every
round hooks each root onto the smallest root across its arcs (a
``scatter_reduce`` with ``amin``) and then jumps pointers until every
vertex points at a root.  Parents only fall and stay inside a component,
so at the fixpoint each component's vertices point at its smallest id.
"""
from __future__ import annotations

import torch


def min_labels(n: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(n,) int64: the smallest vertex id of each vertex's component, for
    the symmetric arc list ``src -> dst``."""
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    p = torch.arange(n, dtype=torch.int64, device=src.device)
    while True:
        q = p.clone()
        q.scatter_reduce_(0, p[src], p[dst], reduce="amin")
        while True:
            qq = q[q]
            if torch.equal(qq, q):
                break
            q = qq
        if torch.equal(q, p):
            return p
        p = q


def read_labels(state: torch.Tensor, slot: torch.Tensor,
                n_pad: int) -> torch.Tensor | None:
    """The program's label of each original vertex: ``state`` holds one
    label per slot, ``slot[v]`` is the slot of vertex v.  None where the
    slot map is no injection into the ``n_pad`` slots."""
    flat = state.reshape(-1)
    slot = slot.to(device=flat.device, dtype=torch.int64)
    if flat.numel() != n_pad or slot.numel() == 0:
        return None
    if int(slot.min()) < 0 or int(slot.max()) >= n_pad:
        return None
    if int(torch.bincount(slot, minlength=n_pad).max()) > 1:
        return None
    return flat[slot].to(torch.int64)


def wrong_vertices(expected: torch.Tensor,
                   labels: torch.Tensor | None) -> int:
    """Vertices whose label disagrees with the components: a vertex is
    wrong where its label differs from its component root's, or where its
    component's label is also another component's.  Every vertex counts as
    wrong where the labels cannot be read."""
    n = expected.numel()
    if labels is None or labels.numel() != n:
        return n
    rootlab = labels[expected]
    split = labels != rootlab
    roots = expected == torch.arange(n, device=expected.device)
    uniq, counts = torch.unique(labels[roots], return_counts=True)
    shared = torch.isin(rootlab, uniq[counts > 1])
    return int((split | shared).sum())
