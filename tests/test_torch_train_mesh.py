"""Port: ``make_train_step`` on the (2, 2) training mesh over
``torch.distributed`` against the JAX package's step on its (2, 2) mesh.

Reduced TinyLlama (dense), Hymba (hybrid), OLMoE (moe: each (data, model)
slice routes its own tokens with its own capacity and its own aux loss, so
the target is the reference's mesh step, not its one-device step) and
Whisper (encoder-decoder) take two steps
from the same train state on the same global batches.  The reference runs
in a subprocess with 4 forced host devices: ``jax.make_mesh`` with Auto
axis types, the step jitted with ``train_state_specs`` / ``batch_specs``
shardings under ``with mesh``.  The port runs on 4 spawned gloo ranks
(``tests/_torch_train_mesh_worker.py``, no JAX) under remat "full" (the
MoE layers' exchanges rerun in the backward): each rank holds its state
as ``placement_specs`` places it (the vocab rows of ``embed`` /
``out_embed``, its heads and columns of the attention, MLP and SSM
leaves, every other leaf whole), and rank 0 gathers the state after the
steps.

Tolerances are ``test_torch_train_step.py``'s: the metrics (loss and nll
rtol 1e-5, grad norm 1e-3, lr 1e-6) after each step, the states through
its ``check_states`` (m within 3e-3 and v within 6e-3 of their leaf's max;
params and master within AdamW's sign-flip bound and their change within
0.1 of the reference's change in norm).  On the mesh the float32 sums run
in another order again: over the data slices, the vocab shards and the
MoE slices.  Gemma-3 (tied embeddings) on (2, 2), and TinyLlama on the
other meshes and with microbatches, are in ``test_torch_train_mesh_more.py``
(each file has its own reference subprocess and spawn).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_train_mesh_worker as worker  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.launch.graph_run import spawn_ranks  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_tp_grad import _spec_paths  # noqa: E402
from test_torch_train import ARCHS, batch_np, cfgs, flat_torch  # noqa: E402
from test_torch_train_step import (GNORM_RTOL, LOSS_RTOL,  # noqa: E402
                                   check_states, opt_cfgs)

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 16
STEPS = 2
SPAWN_TIMEOUT_S = 300
METRIC_RTOL = {"loss": LOSS_RTOL, "nll": LOSS_RTOL, "grad_norm": GNORM_RTOL,
               "lr": 1e-6}

JAX_CODE = textwrap.dedent("""
    import os, sys, pickle, math, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig, get_config
    from repro.launch import shardings as sh
    from repro.models.transformer import ModelContext
    from repro.train import optimizer as jopt, train_step as jts
    with open(sys.argv[1], "rb") as f:
        rounds = pickle.load(f)["rounds"]
    out = {}
    for _, cases in rounds:
        for case in cases:
            if case.get("port_only"):
                continue
            cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                                      **case["over"])
            shape = tuple(case["mesh"])
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:math.prod(shape)])
            like = jts.abstract_train_state(cfg, 1, jnp.float32)
            flat, tdef = jax.tree_util.tree_flatten_with_path(like)
            state = jax.tree_util.tree_unflatten(tdef, [
                jnp.asarray(case["state"][jax.tree_util.keystr(p)])
                for p, _ in flat])
            b0 = case["batches"][0]
            cell = ShapeConfig("t", b0["tokens"].shape[1],
                               b0["tokens"].shape[0], "train")
            abstract = jts.abstract_train_state(cfg, shape[1], jnp.float32)
            placed = sh.named(mesh, sh.train_state_specs(
                cfg, mesh, abstract, zero1=case.get("zero1", False),
                fsdp=case.get("fsdp", False)))
            step = jax.jit(jts.make_train_step(
                cfg, ModelContext(mesh=mesh, remat="none", q_chunk=64),
                jts.StepConfig(n_microbatches=case["micro"],
                               opt=jopt.OptConfig(**case["opt"]))),
                in_shardings=(placed,
                              sh.named(mesh, sh.batch_specs(cfg, cell,
                                                            mesh))))
            metrics = []
            with mesh:
                for b in case["batches"]:
                    # the step's output placement is GSPMD's choice: put
                    # the state back where in_shardings says
                    state, m = step(jax.device_put(state, placed),
                                    jax.tree.map(jnp.asarray, b))
                    metrics.append({k: float(v) for k, v in m.items()})
            out[case["name"]] = {"metrics": metrics, "state": {
                jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(state)[0]}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def train_case(arch, mesh, micro=1, placement=""):
    """A case of the worker's ``train`` kind: a train state drawn by the
    port's init recipe from ``torch.Generator(0)`` (keystr -> numpy; both
    sides start from it) and STEPS global batches; ``placement`` "zero1"
    or "fsdp" sets that flag of ``train_state_specs`` on both sides."""
    jcfg, tcfg = cfgs(arch)
    state = flat_torch(tts.init_train_state(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    jo, _ = opt_cfgs()
    opt = {f.name: getattr(jo, f.name) for f in dataclasses.fields(jo)}
    name = f"{arch}-{mesh[0]}x{mesh[1]}-m{micro}"
    return {"kind": "train", "name": name + (f"-{placement}" if placement
                                             else ""),
            "zero1": placement == "zero1", "fsdp": placement == "fsdp",
            "arch": arch, "over": ARCHS[arch], "mesh": mesh, "micro": micro,
            "remat": "full", "opt": opt, "state": state,
            "batches": [batch_np(jcfg, seed=10 + k, b=B, s=S)
                        for k in range(1, STEPS + 1)]}


def run_both(tmp: Path, rounds) -> tuple:
    """(the reference's results, rank 0's) for every case of
    ``rounds``, the two sides run at the same time."""
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
    with open(tmp / "out.0", "rb") as f:
        got = pickle.load(f)
    return want, got


def _port_tree(arch, flat):
    _, tcfg = cfgs(arch)
    like = tts.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    paths = [p for p, _ in tckpt._leaves_with_paths(like)]
    return tckpt._unflatten(like, iter(
        [torch.from_numpy(np.array(flat[p])) for p in paths]))


def _jax_tree(arch, flat):
    jcfg, _ = cfgs(arch)
    like = jts.abstract_train_state(jcfg, 1, jax.numpy.float32)
    leaves, tdef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(tdef, [
        flat[jax.tree_util.keystr(p)] for p, _ in leaves])


def check_case(case, want, got):
    """The port's metrics of each step and its gathered state against the
    reference's."""
    assert len(got["metrics"]) == len(want["metrics"]) == STEPS
    for k, (tm, jm) in enumerate(zip(got["metrics"], want["metrics"]), 1):
        assert set(tm) == set(jm) == {"loss", "nll", "aux", "grad_norm",
                                      "lr"}
        for key, rtol in METRIC_RTOL.items():
            assert abs(tm[key] - jm[key]) <= rtol * abs(jm[key]), (
                case["name"], key, k, tm[key], jm[key])
        if case["arch"] == "olmoe_1b_7b":
            assert abs(tm["aux"] - jm["aux"]) <= LOSS_RTOL * jm["aux"]
    arch = case["arch"]
    check_states(_port_tree(arch, got["state"]),
                 _jax_tree(arch, want["state"]), STEPS,
                 _jax_tree(arch, case["state"]))
    _, tcfg = cfgs(arch)
    dp, mp = case["mesh"]
    assert got["local_vocab_rows"] == (
        tcfg.padded_vocab(mp) // mp,
        tcfg.d_model // (dp if case.get("fsdp") else 1))
    check_local_shapes(case, got)
    if tcfg.is_moe:       # stored expert shards: E / mp experts a rank
        stacks = {p: s for p, s in got["local_shapes"].items()
                  if "['moe']['w_" in p and not p.endswith("_m']")}
        assert len(stacks) == 12      # 3 stacks of params, master, m, v
        assert {s[1] for s in stacks.values()} == {
            tcfg.moe.n_experts // mp}, stacks


def check_local_shapes(case, got):
    """Rank 0's shape of every leaf is ``local_shape`` of its placed spec
    (``placement_specs`` of ``train_state_specs`` with the case's flags)
    on the case's mesh: each rank holds its blocks only."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import shardings as tsh
    _, tcfg = cfgs(case["arch"])
    mesh = meshlib.Mesh(case["mesh"], ("data", "model"))
    abstract = tts.abstract_train_state(tcfg, mesh.model_size)
    specs = dict(_spec_paths(tsh.placement_specs(tsh.train_state_specs(
        tcfg, mesh, abstract, zero1=case["zero1"], fsdp=case["fsdp"]))))
    shapes = dict(tckpt._leaves_with_paths(abstract))
    assert set(got["local_shapes"]) == set(shapes)
    for path, shape in got["local_shapes"].items():
        assert shape == tsh.local_shape(specs[path], shapes[path].shape,
                                        mesh), (case["name"], path, shape)


MAIN_ARCHS = ("tinyllama_1_1b", "hymba_1_5b", "olmoe_1b_7b",
              "whisper_medium")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cases = [train_case(a, (2, 2)) for a in MAIN_ARCHS]
    want, got = run_both(tmp_path_factory.mktemp("train_mesh"),
                         [(4, cases)])
    return {c["name"]: (c, want[c["name"]], got[c["name"]]) for c in cases}


@pytest.mark.parametrize("arch", MAIN_ARCHS)
def test_train_step_on_the_2x2_mesh_matches_jax(results, arch):
    check_case(*results[f"{arch}-2x2-m1"])
