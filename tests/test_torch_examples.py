"""Port: the four examples (``examples/torch/``) on the CPU against the
reference's calls.

The graph examples at 3,000 vertices: every count, superstep number and
label equals what the reference's own calls give on the same graph
(``repro`` ``hashmin`` / ``sv`` for the quickstart, ``Engine`` for the
analytics example), integer for integer; PageRank to float32 round-off,
the MSF weight to 1e-6.  ``serve_lm`` and ``train_lm`` at a tiny size
return finite tokens and a falling loss.  Each example is loaded from its
file and driven through ``main(argv)``, as a reader runs it.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algorithms.hashmin import hashmin as rhashmin  # noqa: E402
from repro.algorithms.sv import sv as rsv  # noqa: E402
from repro.api import Engine as REngine  # noqa: E402
from repro.core.cost_model import choose_tau  # noqa: E402
from repro.graph import generators as rgen  # noqa: E402
from repro.graph.structs import partition as rpartition  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCALE = 3000
M = 16
PR_RTOL = 1e-5
MSF_RTOL = 1e-6


def example(name):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def quickstart():
    return example("quickstart").main([str(SCALE), "--device", "cpu"])


@pytest.fixture(scope="module")
def analytics():
    return example("graph_analytics").main([str(SCALE), "--device", "cpu"])


def test_quickstart_equals_the_reference(quickstart):
    g = rgen.powerlaw(SCALE, avg_deg=8, alpha=1.8, seed=0).symmetrized()
    tau = choose_tau(g.out_degrees(), M)
    pg = rpartition(g, M, tau=tau, seed=0)
    labels, stats, n = rhashmin(pg, use_mirroring=True)
    _, stats_nom, n_nom = rhashmin(pg, use_mirroring=False)
    labels2, stats2, rounds = rsv(pg)
    got = quickstart
    assert (got["n"], got["m"], got["tau"]) == (g.n, g.m, tau)
    assert got["hashmin_supersteps"] == int(n)
    assert got["hashmin_nom_supersteps"] == int(n_nom)
    assert got["msgs_basic"] == int(stats_nom["msgs_basic"])
    assert got["msgs_combined"] == int(stats_nom["msgs_combined"])
    assert got["msgs_total"] == int(stats["msgs_total"])
    assert got["sv_rounds"] == int(rounds)
    assert got["sv_msgs_basic"] == int(stats2["msgs_basic"])
    assert got["sv_msgs_rr"] == int(stats2["msgs_rr"])
    assert got["per_worker_basic"] == np_(stats2["per_worker_basic"]).tolist()
    assert got["per_worker_rr"] == np_(stats2["per_worker_rr"]).tolist()
    np.testing.assert_array_equal(got["labels"], np_(labels))
    np.testing.assert_array_equal(got["sv_labels"], np_(labels2))
    # mirroring and the combiner cut messages, as the example prints
    assert got["msgs_total"] < got["msgs_combined"] < got["msgs_basic"]


@pytest.fixture(scope="module")
def reference_analytics():
    g = rgen.powerlaw(SCALE, avg_deg=8, alpha=1.8, seed=0,
                      weighted=True).symmetrized()
    tau = choose_tau(g.out_degrees(), M)
    eng = REngine()
    pg = eng.partition(g, M, tau=tau, seed=0)
    return g, tau, pg, {
        "hashmin": eng.run("hashmin", pg), "sv": eng.run("sv", pg),
        "pagerank": eng.run("pagerank", pg, n_iters=10, tol=0.0),
        "sssp": eng.run("sssp", pg, source=int(pg.perm[0])),
        "msf": eng.run("msf", pg)}


def test_analytics_corpus_and_components(analytics, reference_analytics):
    g, tau, _, ref = reference_analytics
    got = analytics
    assert (got["n"], got["m"], got["tau"]) == (g.n, g.m, tau)
    h, r = got["hashmin"], ref["hashmin"]
    assert h["supersteps"] == r.n_supersteps
    assert h["msgs_total"] == int(r.stats["msgs_total"])
    assert h["per_worker_total"] == np_(r.stats["per_worker_total"]).tolist()
    np.testing.assert_array_equal(h["labels"], np_(r.state))
    s, r = got["sv"], ref["sv"]
    assert s["supersteps"] == r.n_supersteps
    for k in ("msgs_rr", "msgs_basic"):
        assert s[k] == int(r.stats[k])
    for k in ("per_worker_rr", "per_worker_basic"):
        assert s[k] == np_(r.stats[k]).tolist()
    np.testing.assert_array_equal(s["labels"], np_(r.state))


def test_analytics_pagerank_and_sssp(analytics, reference_analytics):
    _, _, pg, ref = reference_analytics
    p, r = analytics["pagerank"], ref["pagerank"]
    assert p["supersteps"] == r.n_supersteps
    assert p["msgs_total"] == int(r.stats["msgs_total"])
    want = np_(r.state).reshape(-1)
    np.testing.assert_allclose(p["state"], want, rtol=PR_RTOL,
                               atol=PR_RTOL * float(np.abs(want).max()))
    d, r = analytics["sssp"], ref["sssp"]
    assert d["supersteps"] == r.n_supersteps
    assert d["msgs_total"] == int(r.stats["msgs_total"])
    np.testing.assert_array_equal(d["state"], np_(r.state).reshape(-1))
    assert d["reached"] == int(np.isfinite(np_(r.state)).sum())


def test_analytics_msf(analytics, reference_analytics):
    m, r = analytics["msf"], reference_analytics[3]["msf"]
    labels, total_w, n_edges = r.state
    assert m["supersteps"] == r.n_supersteps
    assert m["edges"] == int(n_edges)
    assert abs(m["weight"] - float(total_w)) <= MSF_RTOL * abs(
        float(total_w))
    for k in ("msgs_rr", "msgs_basic"):
        assert m[k] == int(r.stats[k])
    np.testing.assert_array_equal(m["labels"], np_(labels))


def test_serve_lm_returns_finite_tokens(capsys):
    out = example("serve_lm").main(["--batch", "2", "--prompt-len", "8",
                                    "--gen", "4", "--device", "cpu"])
    assert sorted(out) == sorted(("tinyllama_1_1b", "olmoe_1b_7b",
                                  "mamba2_1_3b"))
    for toks in out.values():
        assert tuple(toks.shape) == (2, 4)
        assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert "All three families served. Done." in capsys.readouterr().out


def test_train_lm_loss_falls(capsys, tmp_path):
    out = example("train_lm").main(["12", "--batch", "2", "--seq", "32",
                                    "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "loss: " in capsys.readouterr().out
    # with --ckpt-dir the run resumes from the directory's checkpoint
    first = example("train_lm").main(["2", "--batch", "2", "--seq", "32",
                                      "--ckpt-dir", str(tmp_path),
                                      "--device", "cpu"])
    assert len(first["losses"]) == 2 and any(tmp_path.iterdir())
