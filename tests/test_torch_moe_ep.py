"""Port: ``moe_ffn_ep`` (expert parallelism over ``torch.distributed``)
against the JAX package's ``moe_ffn_ep`` (``shard_map``).

One spawn of 4 gloo ranks (``tests/_torch_moe_worker.py``, no JAX) runs
``moe_ffn_ep`` on the (dp, ep) meshes (1, 4) and (2, 2), with
``n_mirrored_experts`` 0 and 2 (the mirrored copies tied to experts 0-1),
at capacity factor 1.25, where tokens are dropped; the JAX side runs the
same four cases once, in a subprocess with 4 forced host devices.  Each
rank's cap comes from its own T_loc, so expert parallelism with drops is
not ``moe_ffn_ref`` on all the tokens: the parity target is the
reference's ``moe_ffn_ep`` itself.  Router probabilities of this seed have
no exact tie (asserted), so both sides choose the same experts.

Tolerances (float32): the gathered output within 1e-5 of max|y| (the
k-term gated sums and the products in another order), the aux loss within
rtol 1e-6.  In the same spawn: the mirrored run's occupied send-buffer
rows are fewer than the unmirrored run's by exactly the pairs that run
kept for experts 0-1, on every rank; and a reduced OLMoE at capacity
factor 50 (no drops) gives the same forward, prefill and decode logits
under expert parallelism on (2, 2) as on one device, within 1e-5 of
max|logit|, and the same aux loss on every rank.

Its own file, so that one xdist worker takes the spawn.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_moe_worker as worker  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T, D, E, F, K, CF = 64, 16, 8, 32, 2, 1.25
Y_RTOL = 1e-5
AUX_RTOL = 1e-6
LM_RTOL = 1e-5
SPAWN_TIMEOUT_S = 300

JAX_CODE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import MoEConfig
    from repro.models.moe import MoEContext, moe_ffn_ep, router_probs
    spec = dict(np.load(sys.argv[1]))
    w = {k: jnp.asarray(spec[k]) for k in ("router", "w_gate", "w_up",
         "w_down", "w_gate_m", "w_up_m", "w_down_m")}
    x = jnp.asarray(spec["x"])
    probs = router_probs(x, w["router"], int(spec["k"]))[2]
    out = {"probs": np.asarray(probs)}
    for dp, ep in ((1, 4), (2, 2)):
        mesh = jax.make_mesh((dp, ep), ("data", "model"))
        ctx = MoEContext(mesh=mesh, ep_axis="model", dp_axes=("data",))
        for n_m in (0, 2):
            cfg = MoEConfig(n_experts=int(spec["E"]), top_k=int(spec["k"]),
                            d_ff_expert=int(spec["F"]),
                            capacity_factor=float(spec["cf"]),
                            n_mirrored_experts=n_m)
            y, aux = jax.jit(lambda x: moe_ffn_ep(x, w, cfg, ctx))(x)
            out[f"y_{dp}_{ep}_{n_m}"] = np.asarray(y)
            out[f"aux_{dp}_{ep}_{n_m}"] = np.asarray(aux)
    np.savez(sys.argv[2], **out)
""")


def _spec(path: Path) -> dict:
    rng = np.random.RandomState(5)
    s = np.float32(0.1)
    spec = {"router": rng.randn(D, E), "w_gate": rng.randn(E, D, F),
            "w_up": rng.randn(E, D, F), "w_down": rng.randn(E, F, D)}
    spec = {k: (v.astype(np.float32) * s) for k, v in spec.items()}
    for name in ("w_gate", "w_up", "w_down"):     # mirrors tied to 0-1
        spec[name + "_m"] = spec[name][:2].copy()
    spec["x"] = rng.randn(T, D).astype(np.float32)
    spec.update(E=E, k=K, F=F, cf=CF)
    np.savez(path, **spec)
    return spec


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX results, [rank 0's record, ..., rank 3's])."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    _spec(tmp / "spec.npz")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(tmp / "spec.npz"),
         str(tmp / "jax.npz")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"))
    try:
        spawn_ranks(worker.rank_main, (str(tmp / "store"),
                                       str(tmp / "spec.npz"),
                                       str(tmp / "out")), worker.WORLD,
                    SPAWN_TIMEOUT_S)
    finally:
        _, err = jax_run.communicate(timeout=SPAWN_TIMEOUT_S)
    assert jax_run.returncode == 0, err[-3000:]
    ranks = []
    for r in range(worker.WORLD):
        with open(tmp / f"out.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(np.load(tmp / "jax.npz")), ranks


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


CASES = [(dp, ep, n_m) for dp, ep in worker.MESHES for n_m in worker.MIRRORED]


def test_router_has_no_ties(both):
    p = np.sort(both[0]["probs"], axis=-1)
    assert (np.diff(p, axis=-1) > 0).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "dp%d-ep%d-m%d" % c)
def test_moe_ffn_ep_matches_jax(both, case):
    jax_out, ranks = both
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(r["world"] == 4 for r in ranks)
    dp, ep, n_m = case
    y = np.concatenate([r["ep"][case][0] for r in ranks])
    assert _rel(y, jax_out["y_%d_%d_%d" % case]) <= Y_RTOL
    want = float(jax_out["aux_%d_%d_%d" % case])
    for r in ranks:
        assert abs(r["ep"][case][1] - want) <= AUX_RTOL * abs(want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "dp%d-ep%d-m%d" % c)
def test_each_rank_routes_its_slice_with_its_own_cap(both, case):
    _, ranks = both
    T_loc = T // worker.WORLD
    cap = max(1, int(CF * T_loc * K / E))
    for r in ranks:
        rec = r["ep"][case][2]
        assert (rec["tokens"], rec["pairs"], rec["cap"], rec["rows"]) == (
            T_loc, T_loc * K, cap, E * cap)
        assert int(rec["kept"].sum()) == int(rec["occupied"])
        assert int(rec["load"].sum()) == T_loc * K
        n_m = case[2]
        assert int(rec["sent"]) == T_loc * K - int(rec["load"][:n_m].sum())
        assert not rec["kept"][:n_m].any()
    # capacity factor 1.25 drops tokens somewhere (what makes EP != ref)
    if case[2] == 0:
        assert sum(int(r["ep"][case][2]["occupied"]) for r in ranks) < T * K


@pytest.mark.parametrize("mesh", worker.MESHES, ids=lambda m: "%dx%d" % m)
def test_mirroring_removes_exactly_the_mirrored_pairs(both, mesh):
    """The mirrored experts' kept pairs leave the send buffer; no other
    expert's queue changes."""
    _, ranks = both
    for r in ranks:
        plain = r["ep"][(*mesh, 0)][2]
        mirr = r["ep"][(*mesh, 2)][2]
        assert int(mirr["occupied"]) == int(plain["occupied"]) - int(
            plain["kept"][:2].sum())
        np.testing.assert_array_equal(mirr["kept"][2:], plain["kept"][2:])


def test_model_under_expert_parallelism_equals_one_device(both):
    _, ranks = both
    for r in ranks:
        ep, one = r["lm"]["ep"], r["lm"]["one"]
        assert r["lm"]["n_devices"] == 4
        assert _rel(ep["forward"], one["forward"]) <= LM_RTOL
        # the aux loss under EP is the mean of the ranks' own (the
        # reference's pmean), not one device's: every rank holds the same
        assert ep["aux"] == ranks[0]["lm"]["ep"]["aux"] and ep["aux"] > 0
        assert len(ep["steps"]) == worker.LM_GEN + 1
        for a, b in zip(ep["steps"], one["steps"]):
            assert _rel(a, b) <= LM_RTOL
