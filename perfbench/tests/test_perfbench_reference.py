"""The plain reference against components worked out by hand, and the
comparison's count of wrong vertices on labelings made by hand."""
import pytest
import torch

from perfbench.reference import components


def arcs(n, edges):
    src = [a for a, b in edges] + [b for a, b in edges]
    dst = [b for a, b in edges] + [a for a, b in edges]
    return n, torch.tensor(src), torch.tensor(dst)


HAND = [
    # two triangles, a path and an isolated vertex
    (arcs(10, [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3), (6, 7),
               (7, 8)]),
     [0, 0, 0, 3, 3, 3, 6, 6, 6, 9]),
    # a path whose ids run against its order
    (arcs(6, [(5, 4), (4, 3), (3, 2), (2, 1), (1, 0)]), [0] * 6),
    # a star around its largest id, and a pair
    (arcs(7, [(4, 0), (4, 1), (4, 2), (4, 3), (5, 6)]),
     [0, 0, 0, 0, 0, 5, 5]),
    # no arcs at all
    ((4, torch.zeros(0, dtype=torch.int64),
      torch.zeros(0, dtype=torch.int64)), [0, 1, 2, 3]),
]


@pytest.mark.parametrize("case", range(len(HAND)))
def test_min_labels_by_hand(case):
    (n, src, dst), want = HAND[case]
    assert components.min_labels(n, src, dst).tolist() == want


def test_min_labels_long_path():
    n = 3000
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    edges = list(zip(perm[:-1].tolist(), perm[1:].tolist()))
    got = components.min_labels(*arcs(n, edges))
    assert bool((got == 0).all())


def test_wrong_vertices_by_hand():
    expected = torch.tensor([0, 0, 0, 3, 3, 5])
    ok = torch.tensor([7, 7, 7, 1, 1, 9])       # any label a component
    assert components.wrong_vertices(expected, ok) == 0
    split = torch.tensor([7, 7, 8, 1, 1, 9])    # vertex 2 split off
    assert components.wrong_vertices(expected, split) == 1
    merged = torch.tensor([7, 7, 7, 7, 7, 9])   # two components merged
    assert components.wrong_vertices(expected, merged) == 5
    assert components.wrong_vertices(expected, None) == 6


def test_read_labels_follows_the_slot_map():
    state = torch.tensor([[10, 11, 12], [13, 14, 15]], dtype=torch.int32)
    slot = torch.tensor([5, 0, 3])
    assert components.read_labels(state, slot, 6).tolist() == [15, 10, 13]
    assert components.read_labels(state, torch.tensor([1, 1, 2]), 6) is None
    assert components.read_labels(state, torch.tensor([0, 6, 2]), 6) is None
    assert components.read_labels(state, slot, 8) is None
