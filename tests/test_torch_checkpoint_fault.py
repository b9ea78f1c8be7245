"""Port parity: checkpoints, the elastic re-mesh and the preemption drill
(``repro_torch.train.checkpoint`` and ``repro_torch.train.fault``)
against the JAX package's.

* The reference's five tests, ported: round trip, ``LATEST`` and
  pruning, ``restore_or_init``, the elastic M=8 -> 4 repartition (state
  kept by vertex id, Hash-Min labels unchanged; also equal to the
  reference's repartition) and ``straggler_report``.
* Checkpoints cross between the packages in both directions, bitwise:
  the JAX package saves its GCN params and ``init_opt_state`` and the
  port restores them into its own tree, then the port saves and the JAX
  package restores; the two manifests' ``leaves`` are equal.
* A torn ``LATEST`` (its step has no manifest) reads as no checkpoint; a
  bfloat16 leaf is refused; ``resharded`` on a gloo group of world size 1
  is ``exec.place_args``.
* The GCN preemption drill (n=300, M=8, pallas, 6 epochs, killed after
  3): the resumed loss curve and the final params equal the straight
  ``train_gcn`` run's bitwise (the CPU's sums run in a fixed order).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.graph import generators as rgen  # noqa: E402
from repro.graph import structs as rstructs  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro.train import fault as rfault  # noqa: E402
from repro.train import gcn as rgcn  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch.api import Engine  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import gcn as tgcn  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.fault import (repartition,  # noqa: E402
                                     simulate_preemption, straggler_report)

DIMS = dict(feat_dim=8, hidden=16, n_classes=4)
LR = 1e-2


def tgraph(g) -> tstructs.Graph:
    return tstructs.Graph(g.n, g.src, g.dst, g.weight)


def leaves(tree) -> list:
    return [np.asarray(x.detach().cpu().numpy() if isinstance(
        x, torch.Tensor) else x) for _, x in ckpt._leaves_with_paths(tree)]


def manifest(path) -> dict:
    return json.loads((path / "manifest.json").read_text())


# -- the reference's tests, ported -------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.zeros(4, dtype=torch.int32),
                  {"c": torch.ones(())}]}
    ckpt.save(str(tmp_path), 7, tree)
    out, step = ckpt.restore(str(tmp_path), tree)
    assert step == 7
    assert isinstance(out["b"], list) and isinstance(out["b"][1], dict)
    for x, y in zip(leaves(tree), leaves(out)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    # the reference's leaf order and keystr paths
    rtree = {"a": jnp.zeros((2, 3)), "b": [jnp.zeros(4, jnp.int32),
                                           {"c": jnp.ones(())}]}
    flat, _ = jax.tree_util.tree_flatten_with_path(rtree)
    assert [m["path"] for m in manifest(tmp_path / "step_7")["leaves"]] == [
        jax.tree_util.keystr(p) for p, _ in flat]


def test_checkpoint_latest_and_prune(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_4", "step_5"]


def test_restore_or_init(tmp_path):
    def init():
        return {"w": torch.zeros(3)}
    state, step = ckpt.restore_or_init(str(tmp_path), init)
    assert step == 0
    ckpt.save(str(tmp_path), 42, {"w": torch.ones(3) * 9})
    state2, step2 = ckpt.restore_or_init(str(tmp_path), init)
    assert step2 == 42
    np.testing.assert_array_equal(state2["w"].numpy(), 9.0 * np.ones(3))


def test_elastic_repartition_preserves_state():
    """BSP state survives an elastic M=8 -> M=4 re-mesh by vertex id, as
    the reference's repartition carries it."""
    g = rgen.powerlaw(300, avg_deg=5, seed=1).symmetrized()
    pg8 = tstructs.partition(tgraph(g), 8, tau=16, seed=0, device="cpu")
    state = torch.as_tensor(np.random.RandomState(0).randn(
        pg8.M, pg8.n_loc).astype(np.float32))
    pg4, state4 = repartition(tgraph(g), state, pg8, 4, tau=16, seed=0)
    assert isinstance(state4, torch.Tensor) and state4.device == state.device
    v8 = state.numpy().reshape(-1)[pg8.perm]
    v4 = state4.numpy().reshape(-1)[pg4.perm]
    np.testing.assert_array_equal(v8, v4)
    rpg8 = rstructs.partition(g, 8, tau=16, seed=0)
    rpg4, rstate4 = rfault.repartition(g, state.numpy(), rpg8, 4, tau=16,
                                       seed=0)
    np.testing.assert_array_equal(pg4.perm, rpg4.perm)
    np.testing.assert_array_equal(state4.numpy(), np.asarray(rstate4))
    # and the computation continues correctly on the new mesh
    eng = Engine(device="cpu")
    l4 = eng.run("hashmin", pg4).state.numpy()
    l8 = eng.run("hashmin", pg8).state.numpy()
    np.testing.assert_array_equal(l4.reshape(-1)[pg4.perm],
                                  l8.reshape(-1)[pg8.perm])


def test_straggler_report():
    rep = straggler_report(np.array([10, 10, 10, 70]))
    assert rep["max_over_mean"] == pytest.approx(2.8)
    assert rep["cv"] > 0.9
    flat = straggler_report(np.ones(8))
    assert flat["max_over_mean"] == pytest.approx(1.0)
    assert flat["gini"] == pytest.approx(0.0, abs=1e-9)


# -- across the packages ----------------------------------------------------

@pytest.fixture(scope="module")
def gcn_pair():
    g = rgen.powerlaw(300, avg_deg=5, seed=2, weighted=True).symmetrized()
    rpg = rstructs.partition(g, 8, tau=8, seed=0, layout="csr")
    tpg = tstructs.partition(tgraph(g), 8, tau=8, seed=0, layout="csr",
                             device="cpu")
    return rpg, tpg


def ref_state(rpg):
    p = rgcn.init_gcn_params(rpg, **DIMS, seed=3)
    return {"params": p, "opt": ropt.init_opt_state(p)}


def port_state(tpg):
    p = tgcn.init_gcn_params(tpg, **DIMS, seed=0)
    return {"params": p, "opt": topt.init_opt_state(p)}


def test_the_port_restores_the_references_checkpoint(tmp_path, gcn_pair):
    rpg, tpg = gcn_pair
    want = ref_state(rpg)
    rckpt.save(str(tmp_path), 5, want)
    like = port_state(tpg)
    got, step = ckpt.restore(str(tmp_path), like)
    assert step == 5
    flat, _ = jax.tree_util.tree_flatten(want)
    for x, y, z in zip(flat, leaves(got), leaves(like)):
        assert y.dtype == np.asarray(x).dtype == z.dtype
        np.testing.assert_array_equal(y, np.asarray(x))
    # the seeds differ, so the restore really replaced the port's init
    assert not np.array_equal(leaves(got)[-1], leaves(like)[-1])


def test_the_reference_restores_the_ports_checkpoint(tmp_path, gcn_pair):
    rpg, tpg = gcn_pair
    state = port_state(tpg)
    state["opt"]["step"] = torch.tensor(11, dtype=torch.int32)
    ckpt.save(str(tmp_path / "port"), 6, state)
    like = ref_state(rpg)
    got, step = rckpt.restore(str(tmp_path / "port"), like)
    assert step == 6
    flat, _ = jax.tree_util.tree_flatten(got)
    for x, y in zip(leaves(state), flat):
        assert x.dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(y), x)
    rckpt.save(str(tmp_path / "ref"), 6, like)
    assert (manifest(tmp_path / "port" / "step_6")["leaves"]
            == manifest(tmp_path / "ref" / "step_6")["leaves"])


def test_torn_latest_is_no_checkpoint(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2)})
    (tmp_path / "LATEST").write_text("2")
    (tmp_path / "step_2").mkdir()
    assert ckpt.latest_step(str(tmp_path)) is None
    _, step = ckpt.restore_or_init(str(tmp_path),
                                   lambda: {"a": torch.zeros(2)})
    assert step == 0
    assert rckpt.latest_step(str(tmp_path)) is None


def test_bfloat16_leaf_is_refused(tmp_path):
    """A bfloat16 leaf is saved in the reference's format (manifest dtype
    "bfloat16", its bits as 2-byte voids) and restored bit for bit; a
    manifest that calls a leaf of other items bfloat16 is refused."""
    import json
    tree = {"ok": torch.ones(2), "w": [torch.ones(3, dtype=torch.bfloat16)]}
    ckpt.save(str(tmp_path), 1, tree)
    got, _ = ckpt.restore(str(tmp_path), tree)
    assert got["w"][0].dtype == torch.bfloat16
    assert torch.equal(got["w"][0], tree["w"][0])
    man = tmp_path / "step_1" / "manifest.json"
    meta = json.loads(man.read_text())
    assert [m["dtype"] for m in meta["leaves"]] == ["float32", "bfloat16"]
    meta["leaves"][0]["dtype"] = "bfloat16"      # float32 items
    man.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore(str(tmp_path), tree)


def test_restore_checks_paths_and_shapes(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"a": torch.ones(3, 2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"b": torch.ones(2, 3)})


@pytest.fixture
def group():
    """A gloo group of world size 1 in this process."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(),
                                world_size=1, rank=0)
    yield
    if own:
        meshlib.destroy()


def test_resharded_is_place_args(tmp_path, gcn_pair, group):
    _, tpg = gcn_pair
    sg = texec.shard(tpg, 1, device="cpu")
    state = port_state(tpg)
    ckpt.save(str(tmp_path), 2, state)
    restored, _ = ckpt.restore(str(tmp_path), state)
    rule = tgcn._sharded_leaf(tpg)
    got = ckpt.resharded(restored, sg, rule)
    want = texec.place_args(sg, restored, rule)
    for x, y in zip(leaves(got), leaves(want)):
        np.testing.assert_array_equal(x, y)
    assert got["params"]["emb"].shape == (sg.m_loc, tpg.n_loc,
                                          DIMS["feat_dim"])


# -- the preemption drill ----------------------------------------------------

def drill(pg, ckpt_dir, epochs, backend="pallas"):
    """``run_steps(start, stop)`` of the GCN: restore or init
    {params, opt, step}, train epochs [start, stop) with train_gcn's
    optimizer, save; every call starts from the disk alone."""
    cfg = topt.OptConfig(lr=LR, weight_decay=0.0, clip_norm=1.0,
                         warmup_steps=0, total_steps=epochs,
                         min_lr_frac=1.0)
    step_fn = tgcn.make_gcn_step(cfg, backend)(pg)
    labels, mask = tgcn.gcn_labels(pg, DIMS["n_classes"], 0)

    def init():
        p = tgcn.init_gcn_params(pg, **DIMS, seed=0)
        return {"params": p, "opt": topt.init_opt_state(p),
                "step": torch.zeros((), dtype=torch.int64)}

    def run_steps(start, stop):
        state, at = ckpt.restore_or_init(ckpt_dir, init)
        assert at == start == int(state["step"])
        params, opt = state["params"], state["opt"]
        losses = []
        for _ in range(start, stop):
            (params, opt), metrics = step_fn(params, opt, labels, mask)
            losses.append(float(metrics["loss"]))
        ckpt.save(ckpt_dir, stop, {"params": params, "opt": opt,
                                   "step": torch.tensor(stop)})
        return losses
    return run_steps, init


def test_gcn_preemption_drill_equals_the_straight_run(tmp_path):
    g = rgen.powerlaw(300, avg_deg=5, seed=1, weighted=True).symmetrized()
    pg = tstructs.partition(tgcn.normalize_adjacency(tgraph(g)), 8, tau=8,
                            seed=0, layout="csr", device="cpu")
    epochs, kill = 6, 3
    params, straight = tgcn.train_gcn(pg, **DIMS, epochs=epochs, lr=LR,
                                      backend="pallas")
    run_steps, init = drill(pg, str(tmp_path), epochs)
    resumed = simulate_preemption(run_steps, epochs, kill)
    assert resumed == straight
    final, step = ckpt.restore(str(tmp_path), init())
    assert step == epochs
    for k, v in params.items():
        np.testing.assert_array_equal(final["params"][k].numpy(),
                                      v.numpy(), err_msg=k)
