"""Dry run of the production mesh: rank 0's program of every (arch x shape
x mesh) cell, run on ``meta`` tensors inside a fake world of 256 or 512
ranks, and the roofline inputs it gives (the counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama_1_1b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun]

The reference lowers and compiles each cell on 512 placeholder CPU
devices and reads XLA's analyses.  PyTorch has no lowering; its nearest
counterpart is to run the program itself on tensors without storage.
``lower_cell`` joins a fake process group of the mesh's size as rank 0
(PyTorch's fake backend: every collective returns at once), builds the
mesh (``launch.mesh.make_production_mesh``), places the abstract trees
(``abstract_train_state`` or ``abstract_params``, and ``build_cache``) by
the sharding rules (``placement_specs`` of ``train_state_specs`` /
``param_specs``, ``local_shape`` of rank 0), and runs one
``make_train_step`` step, or ``make_prefill_step`` / ``make_decode_step``,
on the ``meta`` device under three recorders:

* ``FlopCounterMode``: the matrix products' FLOPs (forward, the remat
  recomputation and backward);
* ``comm_stats.record_collectives``: every collective the rank calls,
  the reference's ``collective_bytes`` dict;
* ``Traffic``: the operand and result bytes of every ATen op but a pure
  view (``hbm_bytes_per_chip``: an unfused upper bound on the HBM
  traffic, as no op's result stays in registers or shared memory), and the
  peak of the live bytes of the tensors the step makes
  (``temp_size_in_bytes``: an unfused estimate, outputs included).

``memory_analysis.argument_size_in_bytes`` is the placed state (or params
and cache) and the rank's block of the batch under ``batch_specs``; every
split is even (``local_shape`` refuses any other), so every rank holds as
much as rank 0.

The dry run runs on no device, as the reference's ran on placeholder CPU
devices: it never touches CUDA (the kernels' ``use_kernel("auto", t)``
answers no for a ``meta`` tensor, so the model takes its plain paths).
That is its one difference from the port's other entry points, which run
on the card unless asked for the CPU.  The reference's ``--scan-layers``
has no counterpart: the port runs its layer stacks as a Python loop.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ARCH_IDS, SHAPES, ArchConfig, get_config
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import shardings as sh
from repro_torch.launch.comm_stats import _tensors, record_collectives
from repro_torch.launch.roofline import analyze, link_bw
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import ModelContext
from repro_torch.train.train_step import (StepConfig, abstract_train_state,
                                          make_decode_step,
                                          make_prefill_step, make_train_step)

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
NOTES = {
    "flops_per_chip": "FlopCounterMode on rank 0's step: matrix products "
                      "(forward, remat recomputation, backward); "
                      "elementwise ops are not counted",
    "hbm_bytes_per_chip": "operand and result bytes of every ATen op but a "
                          "pure view: an unfused upper bound",
    "temp_size_in_bytes": "peak live bytes of the tensors the step makes, "
                          "outputs included: an unfused estimate",
    "argument_size_in_bytes": "rank 0's placed state (or params and cache) "
                              "and its block of the batch; every rank "
                              "holds as much",
}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_world(size: int):
    """The default process group as rank 0 of ``size`` ranks on PyTorch's
    fake backend (every collective returns without moving data), destroyed
    with the mesh's subgroups on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        meshlib.destroy()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Traffic(TorchDispatchMode):
    """``bytes``: the operand and result bytes of every ATen op but a pure
    view (collectives are ``comm_stats``'); ``peak``: the most bytes of
    storage that the tensors made inside the block held at once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rets = func._schema.returns
        if func.namespace == "c10d" or (rets and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets)):
            return out
        outs = out if isinstance(out, tuple) else (out,)
        self.bytes += (sum(map(_nbytes, _tensors((args, kwargs))))
                       + sum(map(_nbytes, _tensors(outs))))
        for r, value in zip(rets, outs):
            if r.alias_info is not None:
                continue
            for t in _tensors(value):
                n = t.untyped_storage().nbytes()
                self.live += n
                weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (each leaf its own)."""
    return sum(_nbytes(t) for t in _tensors(_leaves(tree)))


def _leaves(tree) -> list:
    out = []
    sh._walk(tree, lambda _, t: out.append(t))
    return out


def placed(tree, specs, mesh):
    """Rank ``mesh.rank``'s block of each leaf of an abstract tree, as
    ``meta`` tensors of ``local_shape``."""
    return sh._zip(tree, specs, lambda _, t, spec: torch.empty(
        sh.local_shape(spec, tuple(t.shape), mesh), dtype=t.dtype,
        device="meta"))


def abstract_inputs(cfg: ArchConfig, shape, dtype: torch.dtype) -> dict:
    """The cell's global inputs on the ``meta`` device (the reference's
    ``input_specs``): int32 tokens, and the frame embeddings of an
    encoder-decoder model."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": torch.empty((B, 1), dtype=torch.int32,
                                     device="meta")}
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.enc_dec:
        out["enc_embeds"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                        dtype=dtype, device="meta")
    return out


def cell_program(cfg: ArchConfig, shape, mesh, ctx: ModelContext,
                 dtype: torch.dtype = torch.bfloat16, zero1: bool = False,
                 fsdp: bool = False, step_cfg: StepConfig = StepConfig()):
    """(run, arguments): ``run()`` is one step of the cell on rank
    ``mesh.rank``'s placed ``meta`` trees, ``arguments`` their bytes
    ({"params", "opt" | "cache", "batch"})."""
    inputs = abstract_inputs(cfg, shape, dtype)
    bspecs = sh.batch_specs(cfg, shape, mesh)
    args = {"batch": tree_bytes(placed(inputs, bspecs, mesh))}
    if shape.kind == "train":
        state = abstract_train_state(cfg, mesh.model_size, dtype)
        specs = sh.placement_specs(sh.train_state_specs(
            cfg, mesh, state, zero1=zero1, fsdp=fsdp))
        local = placed(state, specs, mesh)
        args.update(params=tree_bytes(local["params"]),
                    opt=tree_bytes(local["opt"]))
        step = make_train_step(cfg, ctx, step_cfg, specs)
        return (lambda: step(local, inputs)), args
    params = zoo.abstract_params(cfg, mesh.model_size, dtype)
    pspecs = sh.placement_specs(sh.param_specs(cfg, mesh, params))
    local = placed(params, pspecs, mesh)
    args["params"] = tree_bytes(local)
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, ctx, max_len=shape.seq_len)
        return (lambda: fn(local, inputs)), args
    cache = zoo.build_cache(cfg, shape.global_batch, shape.seq_len, ctx,
                            dtype=dtype, device="meta")
    args["cache"] = tree_bytes(cache)
    fn = make_decode_step(cfg, ctx, max_len=shape.seq_len)
    return (lambda: fn(local, inputs["token"], cache)), args


def measure(run) -> dict:
    """One call of ``run`` under the three recorders: FLOPs, collectives,
    op bytes, peak live bytes, the outputs' bytes and seconds."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    traffic = Traffic()
    t0 = time.perf_counter()
    with flops, record_collectives() as rec, traffic:
        out = run()
    seconds = time.perf_counter() - t0
    return {"flops": float(flops.get_total_flops()),
            "hbm_bytes": float(traffic.bytes), "peak": traffic.peak,
            "collectives": rec.stats(), "ops": rec.ops,
            "output_bytes": tree_bytes(out), "run_s": seconds,
            "by_op": {str(k): v for k, v in
                      flops.get_flop_counts().get("Global", {}).items()}}


def group_bw(mesh) -> float:
    """The slowest link rate of rank 0's two groups (its model group, the
    first ``model_size`` ranks, and its data group, every
    ``model_size``-th)."""
    mp = mesh.model_size
    return min(link_bw(range(mp)), link_bw(range(0, mesh.size, mp)))


def run_cell(cfg: ArchConfig, shape, mesh, *, dtype=torch.bfloat16,
             embed_method: str = "rr", remat: str = "full",
             zero1: bool = False, fsdp: bool = False, n_micro: int = 1,
             q_chunk: int = 1024, step_cfg: StepConfig = None) -> dict:
    """The artifact's measured fields of one cell on ``mesh`` (this rank
    of the current world, real or fake)."""
    ctx = ModelContext(mesh=mesh, dp_axes=sh.dp_axes(mesh),
                       embed_method=embed_method, remat=remat,
                       q_chunk=q_chunk)
    if step_cfg is None:
        step_cfg = StepConfig(n_microbatches=n_micro)
    t0 = time.perf_counter()
    run, args = cell_program(cfg, shape, mesh, ctx, dtype, zero1, fsdp,
                             step_cfg)
    t_place = time.perf_counter() - t0
    m = measure(run)
    rl = analyze(cfg, shape, mesh.size, m["flops"], m["hbm_bytes"],
                 m["collectives"]["total"]["bytes"], dtype=dtype,
                 coll_bw=group_bw(mesh))
    return {
        "n_chips": mesh.size,
        "flops_per_chip": m["flops"],
        "hbm_bytes_per_chip": m["hbm_bytes"],
        "collectives": m["collectives"],
        "memory_analysis": {
            "argument_size_in_bytes": sum(args.values()),
            "output_size_in_bytes": m["output_bytes"],
            "temp_size_in_bytes": m["peak"],
            "arguments": args},
        "roofline": {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "model_flops": rl.model_flops, "useful_ratio": rl.useful_ratio,
            "roofline_fraction": rl.roofline_fraction},
        "flops_by_op": m["by_op"],
        "ops": [dataclasses.asdict(op) for op in m["ops"]],
        "timing": {"lower_s": t_place, "compile_s": 0.0,
                   "run_s": m["run_s"]},
        "notes": NOTES,
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               embed_method: str = "rr", remat: str = "full",
               zero1: bool = False, n_micro: int = 1, q_chunk: int = 1024,
               extra_tag: str = "", moe_mirror: int = -1,
               fsdp: bool = False) -> dict:
    """Run one cell of the production mesh on ``meta`` tensors in a fake
    world; returns the artifact dict."""
    cfg = get_config(arch)
    if moe_mirror >= 0 and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_mirrored_experts=moe_mirror))
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name,
            "mesh": mesh_name(multi_pod)}
    ok, why = cfg.shape_supported(shape)
    if not ok:
        return dict(head, status="skipped", reason=why)
    dims, _ = MESHES[multi_pod]
    with fake_world(math.prod(dims)):
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
        art = run_cell(cfg, shape, mesh, embed_method=embed_method,
                       remat=remat, zero1=zero1, fsdp=fsdp,
                       n_micro=n_micro, q_chunk=q_chunk)
    art.pop("ops")
    return dict(head, status="ok", options={
        "embed_method": embed_method, "remat": remat, "zero1": zero1,
        "fsdp": fsdp, "n_micro": n_micro, "q_chunk": q_chunk,
        "moe_mirror": moe_mirror, "dtype": "bfloat16", "tag": extra_tag},
        **art)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS + ["all"])
    ap.add_argument("--shape", required=True, choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--embed-method", default="rr",
                    choices=["gather", "onehot", "rr"])
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--fsdp", action="store_true",
                    help="also shard params over data (weight-gathered DP)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--q-chunk", type=int, default=1024)
    ap.add_argument("--moe-mirror", type=int, default=-1,
                    help="override n_mirrored_experts (paper Thm-2 analog)")
    ap.add_argument("--tag", default="")
    return ap


def ok_line(name: str, art: dict) -> str:
    r = art["roofline"]
    return (f"[OK] {name}: dominant={r['dominant']} "
            f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
            f"collective={r['collective_s']:.3e}s "
            f"frac={r['roofline_fraction']:.3f} "
            f"(run {art['timing']['run_s']:.1f}s)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            name = f"{arch}.{shape}.{mesh_name(args.multi_pod)}"
            if args.tag:
                name += f".{args.tag}"
            try:
                art = lower_cell(arch, shape, args.multi_pod,
                                 args.embed_method, args.remat, args.zero1,
                                 args.microbatches, args.q_chunk, args.tag,
                                 moe_mirror=args.moe_mirror, fsdp=args.fsdp)
            except Exception:
                failures += 1
                art = {"arch": arch, "shape": shape, "status": "error",
                       "mesh": mesh_name(args.multi_pod),
                       "trace": traceback.format_exc()}
                print(f"[FAIL] {name}\n{art['trace']}", flush=True)
            (outdir / f"{name}.json").write_text(json.dumps(art, indent=1))
            if art["status"] == "ok":
                print(ok_line(name, art), flush=True)
            elif art["status"] == "skipped":
                print(f"[SKIP] {name}: {art['reason']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
