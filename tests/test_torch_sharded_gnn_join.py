"""Port parity: the sharded GNN path's joins over ``torch.distributed``
(gloo, CPU processes) against the reference's single-device functions;
the broadcast half of the matrix and its machinery are in
``test_torch_sharded_gnn.py``, whose partitions, inputs and spawn this
file shares (its own spawn a world size runs the jobs below on
``_torch_sharded_gnn_worker``, 2 and 4 ranks):

* ``gspmm_sharded``, all three kinds: values (sums within rtol 1e-5, max
  bitwise) and stats exact;
* the gradient of ``sum(join(x) * ct)`` through the sharded
  ``gspmm_join`` against ``jax.grad`` of the reference join, rtol and
  atol 1e-4;
* GCN training on D ranks against ``repro.train.gcn.train_gcn(devices=1)``
  from the same params: the loss history within rtol 2e-4 and atol 2e-5
  (the reference's own sharded contract); every rank's trained params
  bitwise equal to rank 0's; one case has ``hidden == M``, so a
  replicated (M, C) weight is never split by rows;
* ``node_embedding_fetch`` on a ShardedGraph: bitwise against the port's
  one-device fetch;
* the GCN trees' placement rule (``apply_sharded``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gspmm as rgspmm  # noqa: E402
from repro.train import gcn as rgcn  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from test_torch_sharded_gnn import (GCN, GCN_CASES, GRAD_TOL,  # noqa: E402,F401,E501
                                    JOINS, LOSS_ATOL, LOSS_RTOL, M, WORLDS,
                                    _assert_stats, _assert_values, inputs,
                                    parts, spawn_jobs)


@pytest.fixture(scope="module")
def sharded(parts, inputs, tmp_path_factory):  # noqa: F811
    """The join, GCN, fetch and placement jobs' results."""
    return spawn_jobs(parts, inputs, tmp_path_factory,
                      ("gspmm", "grad", "fetch", "gcn", "apply"))


JOIN_IDS = [(D, part, be) for D in WORLDS for part, be, _ in JOINS[D]]


@pytest.mark.parametrize("D,part,be", JOIN_IDS,
                         ids=[f"D{D}-{p}-{b}" for D, p, b in JOIN_IDS])
@pytest.mark.parametrize("kind", rgspmm.GSPMM_KINDS)
def test_gspmm_sharded_equal_one_device(parts, inputs, sharded, D, part, be,
                                        kind):
    x = jnp.asarray(inputs[("gspmm", part)])
    want, wstats = rgspmm.gspmm_stats(parts[part][0], kind, x, backend=be)
    for r in range(D):
        got, stats = sharded[D][r][f"gspmm-{part}-{be}"][kind]
        _assert_values(got, want, "max" if kind.endswith("max") else "sum",
                       f"rank {r}")
        _assert_stats([stats], wstats, f"rank {r}")


@pytest.mark.parametrize("D,part,be", JOIN_IDS,
                         ids=[f"D{D}-{p}-{b}" for D, p, b in JOIN_IDS])
@pytest.mark.parametrize("kind", ["copy_u_sum", "u_mul_e_sum"])
def test_sharded_join_gradient_equal_jax_grad(parts, inputs, sharded, D,
                                              part, be, kind):
    x, ct = (jnp.asarray(a) for a in inputs[("grad", part)])
    join = rgspmm.gspmm_join(parts[part][0], kind, backend=be)
    want = jax.grad(lambda v: jnp.sum(join(v) * ct))(x)
    got = np.concatenate([sharded[D][r][f"grad-{part}-{be}"][kind]
                          for r in range(D)])
    np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


_gcn_ref = {}


GCN_IDS = [(D, c[0]) for D in WORLDS for c in GCN_CASES[D]]


@pytest.mark.parametrize("D,name", GCN_IDS,
                         ids=[f"D{D}-{n}" for D, n in GCN_IDS])
def test_sharded_gcn_equal_the_reference(parts, inputs, sharded, D, name):
    _, part, be, devices, pipe, hidden = next(c for c in GCN_CASES[D]
                                              if c[0] == name)
    key = (part, be, hidden)
    if key not in _gcn_ref:
        p0 = {k: jnp.asarray(v) for k, v in
              inputs[("gcn", part, hidden)].items()}
        _gcn_ref[key] = rgcn.train_gcn(parts[part][0], hidden=hidden,
                                       backend=be, devices=1, params=p0,
                                       **GCN)[1]
    want = _gcn_ref[key]
    got = sharded[D][0][name]
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert got["losses"][-1] < got["losses"][0]
    p = got["params"]
    assert p["emb"].shape == (M, parts[part][1].n_loc, GCN["feat_dim"])
    assert p["W2"].shape == (hidden, GCN["n_classes"])
    assert p["b1"].shape == (hidden,)
    for k, v in p.items():
        assert np.isfinite(v).all(), k
    info = got["info"]
    assert info["host_reads"] >= GCN["epochs"]
    for r in range(1, D):
        other = sharded[D][r][name]
        assert other["losses"] == got["losses"]
        for k, v in p.items():
            np.testing.assert_array_equal(other["params"][k], v, err_msg=k)


@pytest.mark.parametrize("D,part,be", JOIN_IDS,
                         ids=[f"D{D}-{p}-{b}" for D, p, b in JOIN_IDS])
def test_node_embedding_fetch_on_a_sharded_graph(parts, inputs, sharded, D,
                                                 part, be):
    table, ids, fmask = inputs[("fetch", part)]
    want, wstats = temb.node_embedding_fetch(
        parts[part][1], torch.as_tensor(table), torch.as_tensor(ids),
        torch.as_tensor(fmask))
    runs = [sharded[D][r][f"fetch-{part}-{be}"] for r in range(D)]
    np.testing.assert_array_equal(np.concatenate([x[0] for x in runs]),
                                  want.numpy())
    _assert_stats([x[1] for x in runs], wstats)


@pytest.mark.parametrize("D", WORLDS)
def test_apply_sharded_places_leaves_by_the_rule(inputs, sharded, D):
    """The placement rule of the GCN's trees (``train.gcn._sharded_leaf``
    through ``place_args``) splits only the vertex-shaped leaves: the
    replicated (M, C) weight of a GCN with hidden == M reaches every rank
    whole, where ``place_args``'s default leading-axis rule would split
    it; ``apply_sharded`` gathers the embedding back in rank order."""
    want = inputs[("gcn", "hash-csr", M)]
    for r in range(D):
        got = sharded[D][r]["apply"]
        rows = slice(got["w0"], got["w0"] + got["m_loc"])
        assert got["m_loc"] * D == M
        for k, v in want.items():
            np.testing.assert_array_equal(
                got["gcn"][k], v[rows] if k == "emb" else v, err_msg=k)
        assert got["default"]["W2"].shape == (M // D, GCN["n_classes"])
        np.testing.assert_array_equal(got["default"]["W2"], want["W2"][rows])
        np.testing.assert_array_equal(got["emb"], want["emb"])
