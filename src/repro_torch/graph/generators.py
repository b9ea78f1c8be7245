"""Synthetic graphs matched to the paper's dataset families.

* ``powerlaw``  — Chung-Lu-style skewed-degree graph (BTC / Twitter / LJ
  analogs: a few vertices with enormous degree).
* ``grid_road`` — 2-D lattice with random diagonal shortcuts removed
  (USA-road analog: max degree <= 4-ish, huge diameter).
* ``erdos``     — uniform random (WebUK-ish high average degree control).
* ``chain``, ``star``, ``two_cliques`` — adversarial tests.

All return host-side ``Graph``s (directed; call ``.symmetrized()`` for CC
algorithms).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structs import Graph


def _dedup(n, src, dst, w=None):
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if w is not None:
        w = w[keep]
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return Graph(n, src[idx].astype(np.int64), dst[idx].astype(np.int64),
                 None if w is None else w[idx].astype(np.float32))


def powerlaw(n: int, avg_deg: float = 8.0, alpha: float = 2.0,
             seed: int = 0, weighted: bool = False) -> Graph:
    """Chung-Lu: P(edge u->v) ∝ w_u; weights ~ Zipf(alpha)."""
    rng = np.random.RandomState(seed)
    wts = (1.0 / np.arange(1, n + 1) ** (1.0 / (alpha - 1.0)))
    rng.shuffle(wts)
    p = wts / wts.sum()
    m = int(n * avg_deg)
    src = rng.choice(n, size=m, p=p)
    dst = rng.randint(0, n, size=m)
    w = rng.rand(m).astype(np.float32) + 0.01 if weighted else None
    return _dedup(n, src, dst, w)


def grid_road(side: int, seed: int = 0, weighted: bool = False) -> Graph:
    """side x side lattice, 4-neighborhood; both directions stored."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    s, d = [], []
    s.append(idx[:, :-1].ravel()); d.append(idx[:, 1:].ravel())
    s.append(idx[:-1, :].ravel()); d.append(idx[1:, :].ravel())
    src = np.concatenate(s + d)
    dst = np.concatenate(d + s)
    rng = np.random.RandomState(seed)
    w = None
    if weighted:
        half = rng.rand(len(src) // 2).astype(np.float32) + 0.01
        w = np.concatenate([half, half])  # symmetric weights
    return Graph(n, src.astype(np.int64), dst.astype(np.int64), w)


def erdos(n: int, avg_deg: float = 16.0, seed: int = 0,
          weighted: bool = False) -> Graph:
    rng = np.random.RandomState(seed)
    m = int(n * avg_deg)
    src = rng.randint(0, n, size=m)
    dst = rng.randint(0, n, size=m)
    w = rng.rand(m).astype(np.float32) + 0.01 if weighted else None
    return _dedup(n, src, dst, w)


def chain(n: int) -> Graph:
    src = np.arange(n - 1)
    dst = src + 1
    return Graph(n, np.concatenate([src, dst]),
                 np.concatenate([dst, src]))


def star(n: int) -> Graph:
    hub = np.zeros(n - 1, np.int64)
    leaf = np.arange(1, n)
    return Graph(n, np.concatenate([hub, leaf]),
                 np.concatenate([leaf, hub]))


def two_cliques(k: int) -> Graph:
    """Two k-cliques joined by one edge (CC stress)."""
    a = np.arange(k)
    s1, d1 = np.meshgrid(a, a)
    keep = s1 != d1
    s1, d1 = s1[keep], d1[keep]
    src = np.concatenate([s1, s1 + k, [0], [k]])
    dst = np.concatenate([d1, d1 + k, [k], [0]])
    return Graph(2 * k, src.astype(np.int64), dst.astype(np.int64))
