"""LM training driver of the port (the counterpart of
``repro.launch.train``): checkpointed and restartable, on one device
(``--device``, the GPU by default; no fallback to the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 30 --batch 4 --seq 32 --ckpt-dir <dir>
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --steps 10 --batch 4 --seq 2048 --ckpt-every 0 --ckpt-dir <dir>

The reference's flags, ``[train]`` lines and contract: params from
``init_train_state`` (random, drawn from ``torch.Generator(device)``
seeded with ``seed``, so not the reference's numbers), the
``SyntheticLM`` batch of each step (bitwise the reference's), an
encoder-decoder model's frame embeddings drawn from
``np.random.RandomState(step)``, ``ModelContext(remat="none")`` with the
plain path's query chunk at the sequence length, AdamW with 20 warm-up
steps of a cosine schedule over ``steps``, a checkpoint every
``ckpt_every`` steps and at the end, and a restart from the latest one
(``restore_or_init``).  Unlike the reference's fixed default,
``--ckpt-dir`` defaults to a fresh directory under the temporary
directory (``TMPDIR``), made for this run and printed, so that no run
resumes another's checkpoint by accident: to resume, name the
directory.  On the card the attention runs the flash kernel and a Mamba
mixer the SSD kernel; their backwards are plain PyTorch
(``kernels/*/kernel.py``).  TinyLlama-1.1B (the default ``--arch``)
trains at full width and depth on one 80 GB card with ``--full``.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.graph.structs import resolve_device
from repro_torch.models.transformer import EMBED_METHODS, ModelContext
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (StepConfig, init_train_state,
                                          make_train_step)


def run(arch: str, reduced: bool, steps: int, batch: int, seq: int,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50, lr: float = 3e-4,
        seed: int = 0, log_every: int = 10, embed_method: str = "rr",
        device="cuda"):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint if there is one; None makes a fresh directory for
    this run).  Returns the losses of the steps run, as Python floats."""
    dev = resolve_device(device)
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")
        print(f"[train] checkpoints in {ckpt_dir}")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    ctx = ModelContext(remat="none", embed_method=embed_method,
                       q_chunk=max(seq, 64))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))
    step_fn = make_train_step(cfg, ctx, StepConfig(
        opt=OptConfig(lr=lr, warmup_steps=20, total_steps=steps)))

    def init():
        return init_train_state(cfg, torch.Generator(dev).manual_seed(seed),
                                dev, torch.float32)

    state, start = ckpt.restore_or_init(ckpt_dir, init)
    if start:
        print(f"[train] resumed from step {start}")
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        batch_np = data.batch_at(step)
        if cfg.enc_dec:
            rng = np.random.RandomState(step)
            batch_np["enc_embeds"] = rng.randn(
                batch, cfg.enc_seq, cfg.d_model).astype(np.float32)
        state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                         for k, v in batch_np.items()})
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)")
        if ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state)
    if ckpt_every:
        ckpt.save(ckpt_dir, steps, state)
    return losses


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory to write and resume from "
                    "(default: a fresh one under the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--embed-method", default="rr", choices=EMBED_METHODS)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args.arch, args.reduced, args.steps, args.batch, args.seq,
        args.ckpt_dir, args.ckpt_every, args.lr,
        embed_method=args.embed_method, device=args.device)


if __name__ == "__main__":
    main()
