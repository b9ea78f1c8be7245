"""A social graph by the expected-degree (Chung-Lu) model, made on the
device.

The vertex of weight rank r (1-based) has weight r ** -beta, and both ends
of every edge are drawn in proportion to the weights, so that a vertex's
expected degree is 2 E w / sum(w).  ``beta`` is the exponent at which the
graph of ``exponent_of`` (its ``n``, ``undirected_edges`` and
``max_expected_degree``) has that largest expected degree; a graph cut
from it keeps the exponent, and so the shape of the degree law.  Ranks
are dealt to vertex ids by a random permutation (hubs are not the low
ids).  Self-loops and repeated pairs are dropped and edges drawn again
until exactly ``undirected_edges`` distinct pairs remain, chosen
uniformly from those drawn.  Both directions of each pair are returned.

The draws use integer weights (2**40 times the real ones) and an integer
prefix sum, so that the same seed gives the same graph on one device run
after run (a floating-point scan on the GPU is not reproducible).

spec keys: ``n``, ``undirected_edges``, ``exponent_of``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SCALE = 2.0 ** 40
HEAD = 10000


def weight_sum(n: int, beta: float) -> float:
    """sum over r = 1..n of r ** -beta: the first terms exactly, the tail
    by Euler-Maclaurin (an error far below a part in 10**9)."""
    k = min(n, HEAD)
    head = float(np.sum(np.arange(1, k + 1, dtype=np.float64) ** -beta))
    if n == k:
        return head
    a, b = float(k + 1), float(n)

    def f(x, d=0):
        c = 1.0
        for i in range(d):
            c *= -(beta + i)
        return c * x ** (-beta - d)
    integral = (math.log(b / a) if beta == 1.0
                else (b ** (1 - beta) - a ** (1 - beta)) / (1 - beta))
    tail = (integral + 0.5 * (f(a) + f(b)) + (f(b, 1) - f(a, 1)) / 12.0
            - (f(b, 3) - f(a, 3)) / 720.0)
    return head + tail


def solve_beta(n: int, edges: int, dmax: float) -> float:
    """The exponent at which the largest expected degree is ``dmax``."""
    target = 2.0 * edges / dmax            # the weights' sum, w_1 = 1
    lo, hi = 0.0, 4.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if weight_sum(n, mid) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def generate(spec: dict, seed: int, device) -> dict:
    n = int(spec["n"])
    edges = int(spec["undirected_edges"])
    full = spec["exponent_of"]
    beta = solve_beta(int(full["n"]), int(full["undirected_edges"]),
                      float(full["max_expected_degree"]))
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum((w.pow_(-beta) * SCALE).to(torch.int64), 0)
    total = int(cdf[-1])
    ids = torch.randperm(n, generator=gen, device=device)

    def ends(count: int) -> torch.Tensor:
        u = torch.randint(0, total, (count,), generator=gen, device=device)
        return ids[torch.searchsorted(cdf, u, right=True)]

    keys = torch.empty(0, dtype=torch.int64, device=device)
    need = edges
    while need > 0:
        draw = need + need // 16 + 1024
        a, b = ends(draw), ends(draw)
        keep = a != b
        lo = torch.minimum(a, b)[keep]
        hi = torch.maximum(a, b)[keep]
        keys = torch.unique(torch.cat([keys, lo * n + hi]))
        need = edges - keys.numel()
    pick = torch.randperm(keys.numel(), generator=gen, device=device)[:edges]
    keys = torch.sort(keys[pick]).values
    lo, hi = keys // n, keys % n
    return {"n": n, "src": torch.cat([lo, hi]), "dst": torch.cat([hi, lo]),
            "weight": None}
