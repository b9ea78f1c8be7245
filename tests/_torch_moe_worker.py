"""The ranks of ``tests/test_torch_moe_ep.py``: spawned processes that join a
gloo group of world size 4 and run ``moe_ffn_ep`` on the (dp, ep) meshes
(1, 4) and (2, 2) (``moe.ep_context``), each with ``n_mirrored_experts``
0 and 2, on their slice of the tokens; then a reduced OLMoE's forward,
prefill and two decode steps under expert parallelism on the (2, 2) mesh
and on one device.  Each rank writes what it computed.  This module
imports neither JAX nor the JAX package.

The spec (an ``.npz`` the test writes) holds the tokens ``x`` (T, D), the
weights ``w_*`` / ``router`` and the config numbers ``E``, ``k``, ``F``,
``cf``; the mirrored copies are the test's (tied to experts 0-1).
"""
import dataclasses
import datetime
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import MoEConfig, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.models import model_zoo as zoo
from repro_torch.models import moe
from repro_torch.models.transformer import ModelContext

WORLD = 4
MESHES = ((1, 4), (2, 2))
MIRRORED = (0, 2)
GROUP_TIMEOUT_S = 90
LM_ARCH = "olmoe_1b_7b"
LM_B, LM_S, LM_GEN = 2, 6, 2


def ep_cases(spec: dict) -> dict:
    """{(dp, ep, n_m): (this rank's y slice, aux, its routing record)}."""
    x = torch.from_numpy(spec["x"])
    w = {k: torch.from_numpy(spec[k]) for k in (
        "router", "w_gate", "w_up", "w_down", "w_gate_m", "w_up_m",
        "w_down_m")}
    rank = dist.get_rank()
    T_loc = x.shape[0] // WORLD
    xs = x[rank * T_loc:(rank + 1) * T_loc]
    out = {}
    for dp, ep in MESHES:
        ctx = moe.ep_context(dp, ep)
        for n_m in MIRRORED:
            cfg = MoEConfig(n_experts=int(spec["E"]), top_k=int(spec["k"]),
                            d_ff_expert=int(spec["F"]),
                            capacity_factor=float(spec["cf"]),
                            n_mirrored_experts=n_m)
            moe.record = []
            try:
                y, aux = moe.moe_ffn_ep(xs, w, cfg, ctx)
                rec, = moe.record
            finally:
                moe.record = None
            out[(dp, ep, n_m)] = (y.numpy(), float(aux), {
                k: (v.numpy() if torch.is_tensor(v) else v)
                for k, v in rec.items()})
    return out


def lm_run(ctx: ModelContext, params, cfg, tokens) -> dict:
    """The forward's logits and aux, prefill's logits and every decode
    step's, greedy from the prefill."""
    with torch.no_grad():
        logits, aux = zoo.forward_logits(params, cfg, ctx, tokens)
        out = {"forward": logits.numpy(), "aux": float(aux)}
        lg, cache = zoo.prefill(params, cfg, ctx, tokens,
                                max_len=tokens.shape[1] + LM_GEN)
        steps = [lg.numpy()]
        for _ in range(LM_GEN):
            lg, cache = zoo.decode_step(params, cfg, ctx, zoo.greedy(lg),
                                        cache)
            steps.append(lg.numpy())
    out["steps"] = steps
    return out


def lm_cases() -> dict:
    """A reduced OLMoE (capacity factor 50: no drops, so expert
    parallelism computes the one-device function) on the (2, 2) mesh and
    on one device, from the same seed."""
    base = get_config(LM_ARCH).reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=50.0))
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (LM_B, LM_S)).astype(np.int32))
    ep = ModelContext(q_chunk=64, moe=moe.ep_context(2, 2))
    return {"ep": lm_run(ep, params, cfg, tokens),
            "one": lm_run(ModelContext(q_chunk=64), params, cfg, tokens),
            "n_devices": ep.n_devices}


def rank_main(rank: int, store: str, spec_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        spec = dict(np.load(spec_path))
        out = {"ep": ep_cases(spec), "lm": lm_cases(),
               "rank": dist.get_rank(), "world": dist.get_world_size()}
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        meshlib.destroy()
