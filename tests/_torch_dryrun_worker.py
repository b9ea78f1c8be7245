"""The ranks of ``tests/test_torch_dryrun.py``: spawned processes that join
a gloo group of world size 4, build the (2, 2) training mesh and run one
``make_train_step`` step of each case of ``CASES`` on real tensors (the
whole params drawn from the case's seed, each rank's blocks cut by the
placed specs, as ``chip_smoke.py``'s (2, 2) ranks do), recording the
rank's collectives with ``launch.comm_stats.record_collectives`` and the
bytes of the storages behind its state.  Rank r writes ``{case: {"ops",
"bytes"}}`` to ``<out>.<r>``.  This module imports neither JAX nor the
JAX package.
"""
import dataclasses
import datetime
import pickle

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import shardings as sh
from repro_torch.launch.comm_stats import record_collectives
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import ModelContext
from repro_torch.train import data as tdata
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import init_opt_state, tree_leaves

WORLD = 4
MESH = (2, 2)
SHAPE = ShapeConfig("t", 32, 4, "train")
GROUP_TIMEOUT_S = 120
SEED = 0


def case_config(name: str):
    """(cfg, step config, placement flags) of a case: reduced TinyLlama
    under the tensor-parallel placement, ZeRO-1 and fsdp; reduced OLMoE
    under fsdp with stored experts, at a capacity of every token and
    aux_weight 0 (as ``chip_smoke.py``'s OLMoE run)."""
    arch, placement = name.split()
    cfg = get_config(arch).reduced()
    step_cfg = ts.StepConfig()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        step_cfg = ts.StepConfig(aux_weight=0.0)
    flags = {} if placement == "tp" else {placement: True}
    return cfg, step_cfg, flags


CASES = ("tinyllama_1_1b tp", "tinyllama_1_1b zero1",
         "tinyllama_1_1b fsdp", "olmoe_1b_7b fsdp")


def storage_bytes(tree) -> int:
    """The bytes of the storages behind a tree's tensors, each once."""
    seen = {}
    for t in tree_leaves(tree):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def run_case(name: str, mesh) -> dict:
    cfg, step_cfg, flags = case_config(name)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(SEED),
                             "cpu")
    abstract = ts.abstract_train_state(cfg, mesh.model_size, torch.float32)
    specs = sh.placement_specs(sh.train_state_specs(cfg, mesh, abstract,
                                                    **flags))
    local = {"params": sh.shard_tree(params, specs["params"], mesh),
             "opt": init_opt_state(sh.shard_tree(
                 params, specs["opt"]["master"], mesh))}
    batch = {k: torch.from_numpy(v) for k, v in tdata.SyntheticLM(
        tdata.DataConfig(vocab=cfg.vocab, seq_len=SHAPE.seq_len,
                         global_batch=SHAPE.global_batch,
                         seed=SEED)).batch_at(0).items()}
    state_bytes = {"params": storage_bytes(local["params"]),
                   "opt": storage_bytes(local["opt"])}
    step = ts.make_train_step(cfg, ModelContext(mesh=mesh), step_cfg, specs)
    with record_collectives() as rec:
        step(local, batch)
    return {"ops": [dataclasses.asdict(op) for op in rec.ops],
            "bytes": state_bytes}


def rank_main(rank: int, D: int, store: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=D,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = meshlib.make_mesh(MESH, ("data", "model"))
        out = {name: run_case(name, mesh) for name in CASES}
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        meshlib.destroy()
