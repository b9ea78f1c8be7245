"""Port parity: the host graph layer of ``repro_torch`` against ``repro``.

Generators, ``Graph.symmetrized`` and ``partition()`` are numpy in both
packages, so every array must come out equal (values and shapes) for every
generator, balance mode and layout.  ``from_numpy``/``to_numpy`` carry a
reference partition into the port unchanged, which is how the algorithm
parity tests feed both packages the same partition.

The helpers at the top are shared by the other ``test_torch_*`` files.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph import structs as ref_structs  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402

CPU = "cpu"
BAL_LAYOUTS = [(b, lay) for b in ("hash", "edges", "edges+refine", "split",
                                  "vertex-cut")
               for lay in ("padded", "csr") if not (b == "split"
                                                    and lay == "padded")]


# -- shared helpers ----------------------------------------------------------

def ref_fields(pg_ref) -> dict:
    """The reference partition's fields as numpy (device arrays read with
    np.asarray), the input ``from_numpy`` takes."""
    out = {}
    for f in dataclasses.fields(pg_ref):
        if f.name == "plan_cache":
            continue
        v = getattr(pg_ref, f.name)
        if v is not None and not isinstance(v, (int, float, str)):
            v = np.asarray(v)
        out[f.name] = v
    return out


def same_partition(g_ref, M, device=CPU, **kw):
    """(reference partition, the port's copy of it via from_numpy)."""
    pg_ref = ref_structs.partition(g_ref, M, **kw)
    return pg_ref, tstructs.from_numpy(ref_fields(pg_ref), device=device)


def to_np(x):
    """numpy view of a torch tensor, a jax array, or a python value."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_fields_equal(pg_ref, pg_t):
    ref = ref_fields(pg_ref)
    got = tstructs.to_numpy(pg_t)
    assert set(got) <= set(ref)
    for name, want in ref.items():
        if name not in got:
            continue
        have = got[name]
        if want is None or have is None:
            assert want is None and have is None, name
        elif isinstance(want, np.ndarray):
            assert have.shape == want.shape, name
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            assert have == want, name


def graph_pair(kind, n, seed, weighted=False):
    """The same host graph from both packages' generators."""
    if kind == "powerlaw":
        a = ref_gen.powerlaw(n, avg_deg=6, seed=seed, weighted=weighted)
        b = tgen.powerlaw(n, avg_deg=6, seed=seed, weighted=weighted)
    elif kind == "road":
        side = int(np.sqrt(n))
        a = ref_gen.grid_road(side, seed=seed, weighted=weighted)
        b = tgen.grid_road(side, seed=seed, weighted=weighted)
    else:
        a = ref_gen.erdos(n, avg_deg=8, seed=seed, weighted=weighted)
        b = tgen.erdos(n, avg_deg=8, seed=seed, weighted=weighted)
    return a.symmetrized(), b.symmetrized()


def assert_graph_equal(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    if a.weight is None:
        assert b.weight is None
    else:
        np.testing.assert_array_equal(a.weight, b.weight)


# -- generators ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["powerlaw", "road", "erdos"])
@pytest.mark.parametrize("weighted", [False, True])
def test_generators_and_symmetrized_equal(kind, weighted):
    a, b = graph_pair(kind, 900, seed=3, weighted=weighted)
    assert_graph_equal(a, b)


def test_adversarial_generators_equal():
    for name, arg in [("chain", 50), ("star", 40), ("two_cliques", 9)]:
        assert_graph_equal(getattr(ref_gen, name)(arg),
                           getattr(tgen, name)(arg))


# -- partition ----------------------------------------------------------------

@pytest.mark.parametrize("balance,layout", BAL_LAYOUTS)
@pytest.mark.parametrize("kind", ["powerlaw", "road"])
def test_partition_fields_equal(kind, balance, layout):
    g_ref, g_t = graph_pair(kind, 700, seed=5, weighted=True)
    kw = dict(tau=12, seed=2, layout=layout, balance=balance,
              split_factor=1.1)
    pg_ref = ref_structs.partition(g_ref, 8, **kw)
    pg_t = tstructs.partition(g_t, 8, device=CPU, **kw)
    assert_fields_equal(pg_ref, pg_t)
    assert pg_t.device.type == "cpu"
    np.testing.assert_array_equal(pg_t.edge_load(phys=True),
                                  pg_ref.edge_load(phys=True))


@pytest.mark.parametrize("tau,hosts", [(None, None), (6, 2)])
def test_partition_mirroring_off_and_host_placement(tau, hosts):
    g_ref, g_t = graph_pair("powerlaw", 500, seed=9)
    kw = dict(tau=tau, seed=1, layout="csr", balance="edges+refine",
              hosts=hosts)
    assert_fields_equal(ref_structs.partition(g_ref, 8, **kw),
                        tstructs.partition(g_t, 8, device=CPU, **kw))


def test_partition_rejects_what_the_reference_rejects():
    _, g_t = graph_pair("powerlaw", 200, seed=0)
    with pytest.raises(ValueError, match="layout"):
        tstructs.partition(g_t, 4, layout="coo", device=CPU)
    with pytest.raises(ValueError, match="balance"):
        tstructs.partition(g_t, 4, balance="metis", device=CPU)
    with pytest.raises(ValueError, match="csr"):
        tstructs.partition(g_t, 4, balance="split", layout="padded",
                           device=CPU)


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_from_numpy_to_numpy_round_trip(layout):
    g_ref, _ = graph_pair("powerlaw", 400, seed=4, weighted=True)
    pg_ref, pg_t = same_partition(g_ref, 4, tau=8, seed=0, layout=layout)
    assert_fields_equal(pg_ref, pg_t)
    again = tstructs.from_numpy(tstructs.to_numpy(pg_t), device=CPU)
    assert_fields_equal(pg_ref, again)
    # the host copies the plan packer reads are the device arrays' values
    for name, arr in again.host.items():
        np.testing.assert_array_equal(arr, getattr(again, name).numpy())


def test_pinned_perm_partition_equal():
    g_ref, g_t = graph_pair("powerlaw", 300, seed=6)
    perm = np.random.RandomState(1).permutation(g_ref.n)
    kw = dict(tau=9, layout="csr", perm=perm)
    assert_fields_equal(ref_structs.partition(g_ref, 4, **kw),
                        tstructs.partition(g_t, 4, device=CPU, **kw))


def test_canonical_labels_equal():
    g_ref, _ = graph_pair("powerlaw", 400, seed=8)
    pg_ref, pg_t = same_partition(g_ref, 4, tau=8, seed=3, layout="csr")
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 40, (pg_ref.M, pg_ref.n_loc)).astype(np.int32)
    want = ref_structs.canonical_labels(pg_ref, labels)
    np.testing.assert_array_equal(
        tstructs.canonical_labels(pg_t, torch.from_numpy(labels)), want)
    np.testing.assert_array_equal(
        tstructs.canonical_labels(pg_t, labels), want)


def test_local_ids_and_edge_src_values():
    g_ref, _ = graph_pair("powerlaw", 300, seed=2)
    for layout in ("padded", "csr"):
        pg_ref, pg_t = same_partition(g_ref, 4, tau=7, seed=0,
                                      layout=layout)
        np.testing.assert_array_equal(pg_t.local_ids().numpy(),
                                      np.asarray(pg_ref.local_ids()))
        state = np.random.RandomState(1).rand(
            pg_ref.M, pg_ref.n_loc).astype(np.float32)
        want = pg_ref.edge_src_values(state, pg_ref.all_src)
        got = pg_t.edge_src_values(torch.from_numpy(state), pg_t.all_src)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
