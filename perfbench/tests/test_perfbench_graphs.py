"""The generators: the same seed gives the same graph, another seed
another, and the shape the configuration states."""
import pytest
import torch

from conftest import REPO, TINY
from perfbench.harness import spec

GENERATORS = {"lj": "chung_lu", "road": "road_lattice"}


def make(name, seed, graph=None):
    gen = spec.load_module(REPO / "perfbench" / "graphs"
                           / f"{GENERATORS[name]}.py")
    return gen.generate(graph or TINY[name], seed, "cpu")


def arcs_of(a):
    return torch.stack([a["src"], a["dst"]])


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_same_seed_same_graph(name):
    a, b, c = make(name, 2**31 + 17), make(name, 2**31 + 17), make(name, 5)
    assert torch.equal(arcs_of(a), arcs_of(b))
    assert not torch.equal(arcs_of(a), arcs_of(c))
    if a["weight"] is not None:
        assert torch.equal(a["weight"], b["weight"])


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("seed", [0, 9, 2**31 + 1])
def test_shape(name, seed):
    a = make(name, seed)
    n, src, dst = a["n"], a["src"], a["dst"]
    assert n == TINY[name]["n"]
    arcs = (2 * TINY[name]["undirected_edges"] if name == "lj"
            else TINY[name]["arcs"])
    assert src.numel() == dst.numel() == arcs
    assert bool((src != dst).all())                    # no self-loops
    assert int(src.min()) >= 0 and int(src.max()) < n
    key = src * n + dst
    assert torch.unique(key).numel() == arcs           # no repeated arc
    back = torch.sort(dst * n + src).values
    assert torch.equal(torch.sort(key).values, back)   # symmetric
    deg = torch.bincount(src, minlength=n)
    if name == "road":
        assert int(deg.max()) <= 4
        assert abs(float(deg.float().mean()) - 2.4393) < 1e-3
        assert bool(((dst - src).abs() == 1).logical_or(
            (dst - src).abs() == TINY["road"]["width"]).all())
        w = a["weight"]
        assert w.shape == src.shape and float(w.min()) >= 1.0
    else:
        assert abs(float(deg.float().mean()) - 17.67) < 1e-6
        top = TINY["lj"]["exponent_of"]["max_expected_degree"]
        assert 0.6 * top < int(deg.max()) < 1.5 * top


def test_chung_lu_exponent_hits_the_largest_degree():
    gen = spec.load_module(REPO / "perfbench" / "graphs" / "chung_lu.py")
    n, e, dmax = 4847571, 42850000, 20000
    beta = gen.solve_beta(n, e, dmax)
    r = torch.arange(1, n + 1, dtype=torch.float64)
    assert abs(2 * e / float(r.pow(-beta).sum()) - dmax) < 1e-3
    assert 0.0 < beta < 1.0


def test_a_cell_deals_one_graph_in_orders_drawn_from_the_seed(tiny_root):
    """Every seed gives the program the same arcs (the configuration's
    graph), in another order: the same work."""
    from perfbench.harness import cell as cell_mod
    c = spec.load_cell("road.sv", tiny_root)
    a = cell_mod.make_graph(c, 3, torch.device("cpu"))
    b = cell_mod.make_graph(c, 2**31 + 3, torch.device("cpu"))
    assert not torch.equal(a["src"], b["src"])
    key = [torch.sort(x["src"] * x["n"] + x["dst"]).values for x in (a, b)]
    assert torch.equal(*key)
    again = cell_mod.make_graph(c, 3, torch.device("cpu"))
    assert cell_mod.fingerprint(again) == cell_mod.fingerprint(a)
