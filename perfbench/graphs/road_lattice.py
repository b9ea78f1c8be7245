"""A road network analog: a planar lattice of ``n`` intersections whose
bonds are kept so that the arcs a vertex match the source's, made on the
device from the seed.

Vertex v sits at row v // width, column v % width (ids are lattice-local,
as a road graph's ids are local in space); the last row may be partial.
Of the lattice's bonds (each vertex to its right and lower neighbour),
exactly ``arcs / 2`` are kept, chosen uniformly without replacement, so
every seed gives the same n and number of arcs and no vertex has degree
above 4.  Each kept bond has a travel distance drawn uniformly from
[1, 2) (the same both ways).  Both directions are returned.

spec keys: ``n``, ``arcs`` (even), ``width``.
"""
from __future__ import annotations

import torch


def generate(spec: dict, seed: int, device) -> dict:
    n, arcs, width = int(spec["n"]), int(spec["arcs"]), int(spec["width"])
    if arcs % 2:
        raise ValueError("a symmetric graph has an even number of arcs")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    v = torch.arange(n, dtype=torch.int64, device=device)
    right = v[(v % width < width - 1) & (v + 1 < n)]
    down = v[v + width < n]
    a = torch.cat([right, down])
    b = torch.cat([right + 1, down + width])
    keep = arcs // 2
    if keep > a.numel():
        raise ValueError(f"{keep} bonds asked of a lattice with {a.numel()}")
    pick = torch.sort(torch.randperm(a.numel(), generator=gen,
                                     device=device)[:keep]).values
    a, b = a[pick], b[pick]
    w = 1.0 + torch.rand(keep, generator=gen, device=device,
                         dtype=torch.float32)
    return {"n": n, "src": torch.cat([a, b]), "dst": torch.cat([b, a]),
            "weight": torch.cat([w, w])}
