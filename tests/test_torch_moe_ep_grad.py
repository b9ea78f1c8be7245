"""Port: the gradients of expert parallelism (``moe_ffn_ep`` and
``transformer._moe_call`` under autograd) against ``jax.grad`` of the JAX
package's ``moe_ffn_ep`` on its mesh.

Before this was repaired the port's collectives were not autograd-aware:
``_moe_call``'s output carried no gradient and the experts of
``moe_ffn_ep`` got none.  The loss is sum(y * cot) + 0.5 * aux on the
(dp, ep) meshes (1, 2) and (2, 2), with ``n_mirrored_experts`` 0 and 2
(the mirrored copies leaves of their own), at capacity factor 1.25
(tokens dropped, each rank at its own cap).  The reference runs in a
subprocess with 4 forced host devices; the port on gloo ranks
(``tests/_torch_train_mesh_worker.py``, no JAX) in two forms:
``moe_ffn_ep`` on each rank's slice (x's gradient gathered) and
``_moe_call`` on the replicated tokens (x's gradient whole on every
rank), the weights' gradients summed over the ranks.  The aux loss, a
mean of the ranks' own, enters each rank's gradient once: a factor of the
world size here is the fault the repair removed.

Tolerances (float32): every gradient within ``GRAD_RTOL`` = 1e-5 of its
max (the k-term gated sums and the experts' products in another order),
y within 1e-5 of its max, the aux loss within rtol 1e-6.
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

import _torch_train_mesh_worker as worker  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T, D, E, F, K, CF = 64, 16, 8, 32, 2, 1.25
AUX_WEIGHT = 0.5
GRAD_RTOL = 1e-5
AUX_RTOL = 1e-6
MESHES = {2: (1, 2), 4: (2, 2)}
MIRRORED = (0, 2)
SPAWN_TIMEOUT_S = 300

JAX_CODE = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import MoEConfig
    from repro.models.moe import MoEContext, moe_ffn_ep
    LEAVES = ("router", "w_gate", "w_up", "w_down", "w_gate_m", "w_up_m",
              "w_down_m")
    with open(sys.argv[1], "rb") as f:
        rounds = pickle.load(f)["rounds"]
    out = {}
    for _, cases in rounds:
        for c in cases:
            dp, ep = c["mesh"]
            mesh = jax.make_mesh((dp, ep), ("data", "model"),
                                 devices=jax.devices()[:dp * ep])
            ctx = MoEContext(mesh=mesh, ep_axis="model", dp_axes=("data",))
            cfg = MoEConfig(**c["cfg"])
            cot = jnp.asarray(c["cot"])

            def loss(x, w):
                y, aux = moe_ffn_ep(x, w, cfg, ctx)
                return jnp.sum(y * cot) + c["aux_weight"] * aux, (y, aux)
            w = {k: jnp.asarray(c[k]) for k in LEAVES}
            (gx, gw), (y, aux) = jax.jit(jax.grad(
                loss, argnums=(0, 1), has_aux=True))(jnp.asarray(c["x"]), w)
            out[c["name"]] = {"x": np.asarray(gx), "y": np.asarray(y),
                              "aux": float(aux),
                              **{k: np.asarray(gw[k]) for k in LEAVES}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _case(mesh, n_m) -> dict:
    rng = np.random.RandomState(5)
    s = np.float32(0.1)
    c = {"router": rng.randn(D, E), "w_gate": rng.randn(E, D, F),
         "w_up": rng.randn(E, D, F), "w_down": rng.randn(E, F, D)}
    c = {k: (v.astype(np.float32) * s) for k, v in c.items()}
    for name in ("w_gate", "w_up", "w_down"):     # own leaves, experts 0-1
        c[name + "_m"] = c[name][:2].copy()
    c.update(x=rng.randn(T, D).astype(np.float32),
             cot=rng.randn(T, D).astype(np.float32),
             kind="moe", name="%dx%d-m%d" % (*mesh, n_m), mesh=mesh,
             aux_weight=AUX_WEIGHT,
             cfg=dict(n_experts=E, top_k=K, d_ff_expert=F,
                      capacity_factor=CF, n_mirrored_experts=n_m))
    return c


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep_grad")
    rounds = [(w, [_case(m, n_m) for n_m in MIRRORED])
                for w, m in MESHES.items()]
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump({"rounds": rounds}, f)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(tmp / "spec.pkl"),
         str(tmp / "jax.pkl")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"))
    try:
        spawn_ranks(worker.rank_main, (str(tmp), str(tmp / "spec.pkl"),
                                       str(tmp / "out")), worker.WORLD,
                    SPAWN_TIMEOUT_S)
    finally:
        _, err = jax_run.communicate(timeout=SPAWN_TIMEOUT_S)
    assert jax_run.returncode == 0, err[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    ranks = []
    for r in range(worker.WORLD):
        with open(tmp / f"out.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    return want, ranks


def _rel(got, want):
    assert got.shape == want.shape
    return float(np.max(np.abs(got.astype(np.float64) - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


NAMES = ["%dx%d-m%d" % (*m, n_m) for m in MESHES.values() for n_m in MIRRORED]


@pytest.mark.parametrize("form", ["ep", "call"])
@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(both, name, form):
    want, ranks = both
    w = want[name]
    world = int(name[0]) * int(name[2])
    for r in range(world):
        got = ranks[r][name][form]
        for leaf in ("x",) + worker.MOE_LEAVES:
            if leaf.endswith("_m") and name.endswith("m0"):
                assert not got[leaf].any()          # no mirrored expert
                continue
            assert _rel(got[leaf], w[leaf]) <= GRAD_RTOL, (r, leaf)
        assert abs(got["aux"] - w["aux"]) <= AUX_RTOL * abs(w["aux"])
    if form == "call":
        assert _rel(ranks[0][name]["call"]["y"], w["y"]) <= GRAD_RTOL
    else:
        y = np.concatenate([ranks[r][name]["ep"]["y"] for r in range(world)])
        assert _rel(y, w["y"]) <= GRAD_RTOL


def test_every_expert_and_the_router_get_a_gradient(both):
    """The fault itself: every expert leaf and x get a nonzero gradient."""
    _, ranks = both
    for name in NAMES:
        for form in ("ep", "call"):
            got = ranks[0][name][form]
            for leaf in ("x", "router", "w_gate", "w_up", "w_down"):
                assert np.abs(got[leaf]).max() > 0, (name, form, leaf)
