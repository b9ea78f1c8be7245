"""Port parity: S-V, MSF and attribute broadcast through ``Engine.run``.

The conformance rows of ``tests/test_conformance.py`` for the three
request-respond algorithms: padded/csr x dense/pallas, then the five
balance modes on csr/pallas.  Both packages run on the SAME partition of
a weighted, symmetrized 500-vertex power-law graph (the reference's,
carried into the port with ``from_numpy``).  S-V and MSF labels, MSF's
edge count and the per-edge attributes must be bitwise equal; MSF's total
weight (a float32 sum each round, in another order) within 1e-6
relative; every ``msgs_*`` / ``per_worker_*`` equal, integer for integer;
``n_supersteps`` equal.  The reference's runs are memoized per
configuration: each costs seconds of ``jit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import union_find_cc  # noqa: E402
from repro import api as rapi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from test_torch_algorithms import assert_totals_equal  # noqa: E402
from test_torch_graph import graph_pair, same_partition  # noqa: E402

CPU = "cpu"
ALGOS = ("sv", "msf", "attr_bcast")
LAYOUT_BACKEND = [("padded", "dense"), ("padded", "pallas"),
                  ("csr", "dense"), ("csr", "pallas")]
BALANCES = ("hash", "edges", "edges+refine", "split", "vertex-cut")

_parts = {}
_ref_runs = {}


def _partition(layout, balance):
    key = (layout, balance)
    if key not in _parts:
        g_ref, _ = graph_pair("powerlaw", 500, seed=27, weighted=True)
        _parts[key] = same_partition(g_ref, 6, tau=10, seed=1,
                                     layout=layout, balance=balance,
                                     split_factor=1.0)
    return _parts[key]


def _attr(pg, xp):
    """3 * arange(n_pad) as the (M, n_loc) vertex attribute (exact in
    float32)."""
    if xp is torch:
        return torch.arange(pg.n_pad, dtype=torch.float32).reshape(
            pg.M, pg.n_loc) * 3
    return jnp.arange(pg.n_pad, dtype=jnp.float32).reshape(
        pg.M, pg.n_loc) * 3


def _run_both(algo, layout, backend, balance="hash"):
    pg_ref, pg_t = _partition(layout, balance)
    cfg = dict(backend=backend, layout=layout, balance=balance)
    key = (algo, layout, backend, balance)
    pr, pt = {}, {}
    if algo == "attr_bcast":
        pr, pt = {"attr": _attr(pg_ref, jnp)}, {"attr": _attr(pg_t, torch)}
    if key not in _ref_runs:
        _ref_runs[key] = rapi.Engine(**cfg).run(algo, pg_ref, **pr)
    ra = _ref_runs[key]
    rb = tapi.Engine(device=CPU, **cfg).run(algo, pg_t, **pt)
    assert rb.n_supersteps == int(ra.n_supersteps)
    assert_totals_equal(ra.stats, rb.stats)
    assert set(rb.stats) == {"msgs_rr", "msgs_basic", "per_worker_rr",
                             "per_worker_basic"}
    return pg_ref, pg_t, ra, rb


def _assert_results(algo, ra, rb):
    if algo == "msf":
        (la, wa, na), (lb, wb, nb) = ra.state, rb.state
        assert lb.dtype == torch.int32
        np.testing.assert_array_equal(lb.numpy(), np.asarray(la))
        assert int(nb) == int(na)
        np.testing.assert_allclose(float(wb), float(wa), rtol=1e-6)
        assert rb.jump_reads >= rb.n_supersteps
    else:
        assert rb.state.dtype == (torch.int32 if algo == "sv"
                                  else torch.float32)
        np.testing.assert_array_equal(rb.state.numpy(), np.asarray(ra.state))
    assert int(rb.stats["msgs_rr"]) <= int(rb.stats["msgs_basic"])


@pytest.mark.parametrize("layout,backend", LAYOUT_BACKEND)
@pytest.mark.parametrize("algo", ALGOS)
def test_conformance_rows_equal(algo, layout, backend):
    _, _, ra, rb = _run_both(algo, layout, backend)
    _assert_results(algo, ra, rb)


@pytest.mark.parametrize("balance", BALANCES)
@pytest.mark.parametrize("algo", ALGOS)
def test_balance_modes_equal(algo, balance):
    _, _, ra, rb = _run_both(algo, "csr", "pallas", balance)
    _assert_results(algo, ra, rb)


@pytest.mark.parametrize("algo", ["sv", "msf"])
def test_labels_are_the_components(algo):
    """S-V and MSF labels partition the vertices as union-find does, and
    MSF keeps n - #components edges; S-V labels are Hash-Min's."""
    _, pg_t, _, rb = _run_both(algo, "csr", "pallas")
    labels = rb.state[0] if algo == "msf" else rb.state
    g_ref, _ = graph_pair("powerlaw", 500, seed=27, weighted=True)
    oc = union_find_cc(g_ref.n, g_ref.src, g_ref.dst)
    lab = labels.numpy().reshape(-1)[pg_t.perm]
    _, canon = np.unique(oc, return_inverse=True)
    _, mine = np.unique(lab, return_inverse=True)
    assert len(np.unique(canon)) == len(np.unique(mine))
    for comp in np.unique(canon):
        assert len(np.unique(mine[canon == comp])) == 1
    if algo == "msf":
        assert int(rb.state[2]) == g_ref.n - len(np.unique(oc))
    else:
        hm = tapi.Engine(device=CPU, backend="pallas", layout="csr").run(
            "hashmin", pg_t)
        vm = pg_t.vmask
        assert torch.equal(rb.state[vm], hm.state[vm])


def test_sv_ids_stay_int32_on_every_channel_call(monkeypatch):
    """The CPU-sized guard for ids at 2^24: every S-V channel call carries
    int32 labels, targets and updates (a float32 round trip would merge
    components there)."""
    from repro_torch.algorithms import sv
    seen = []

    def spy(name, fn):
        def call(pg, *tensors, **kw):
            seen.append((name, [t.dtype for t in tensors
                                if isinstance(t, torch.Tensor)
                                and t.dtype != torch.bool]))
            return fn(pg, *tensors, **kw)
        return call
    for name in ("gather", "broadcast", "scatter_state"):
        monkeypatch.setattr(sv, name, spy(name, getattr(sv, name)))
    _, pg_t = _partition("csr", "hash")
    res = tapi.Engine(device=CPU, backend="pallas", layout="csr").run(
        "sv", pg_t)
    assert res.state.dtype == torch.int32
    # a superstep: 4 pointer reads, 1 broadcast, 3 hooking writes
    names = [n for n, _ in seen]
    assert {n: names.count(n) for n in set(names)} == {
        "gather": 4 * res.n_supersteps, "broadcast": res.n_supersteps,
        "scatter_state": 3 * res.n_supersteps}
    for name, dtypes in seen:
        assert dtypes and all(d == torch.int32 for d in dtypes), (name,
                                                                  dtypes)


def test_attr_bcast_dedup_off_same_values_basic_counts():
    """Without dedup the channel sends every request: the same per-edge
    values, and msgs_rr == msgs_basic."""
    from repro_torch.core.channels import gather_edges
    _, pg_t = _partition("csr", "hash")
    attr = _attr(pg_t, torch)
    on, s_on = gather_edges(pg_t, attr, pg_t.all_dst, pg_t.all_mask)
    off, s_off = gather_edges(pg_t, attr, pg_t.all_dst, pg_t.all_mask,
                              dedup=False)
    assert torch.equal(on, off)
    assert torch.equal(on, attr.reshape(-1)[pg_t.all_dst.long()])
    assert int(s_off["msgs_rr"]) == int(s_off["msgs_basic"])
    assert torch.equal(s_off["per_worker_rr"], s_off["per_worker_basic"])
    assert int(s_on["msgs_rr"]) < int(s_off["msgs_rr"])


@pytest.mark.parametrize("algo", ALGOS)
def test_graph_run_cli_on_the_cpu(algo, capsys):
    from repro_torch.launch import graph_run
    graph_run.main(["--algo", algo, "--n", "2000", "--workers", "4",
                    "--backend", "pallas", "--layout", "csr",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[run] {algo}:" in out
    assert "msgs_rr" in out and "msgs_basic" in out
    if algo == "msf":
        assert "[msf] total weight" in out
