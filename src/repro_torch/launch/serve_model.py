"""Model serving driver of the port: batched prefill + greedy decode with
KV/SSM caches, on one device (``--device``, the GPU by default).

    PYTHONPATH=src python -m repro_torch.launch.serve_model \\
        --arch hymba_1_5b --reduced --batch 4 --prompt-len 32 --gen 32

The same flags and ``[serve]`` lines as ``repro.launch.serve_model``.
Every architecture of ``ARCH_IDS`` runs: the stage kinds ``dense``,
``ssm``, ``hybrid`` and ``moe`` (tinyllama, mamba2, hymba, gemma3, olmoe,
llama4 scout, ...) and the encoder-decoder Whisper, whose encoder takes
frame embeddings of shape (batch, enc_seq, d_model) in place of the stub
audio front end.  OLMoE-1B-7B serves at full width on one 80 GB card
(``--arch olmoe_1b_7b --no-reduced``, 28 GB of float32 weights), and so
does Whisper-medium (``--arch whisper_medium --no-reduced``: 24 encoder
and 24 decoder layers, 1500 frames, 4 GB); ``--reduced --device cpu``
serves either's smoke config on the CPU.  The weights are random, drawn
from ``torch.Generator(device)`` seeded with ``seed``; the prompts, and
then the frame embeddings (standard normals), are drawn with numpy as
the reference draws them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.graph.structs import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import ModelContext


def run(arch: str, reduced: bool, batch: int, prompt_len: int, gen: int,
        seed: int = 0, device="cuda"):
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and generate
    ``gen`` tokens each greedily.  Returns the (batch, gen) int32 tokens
    on the host."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    ctx = ModelContext(q_chunk=max(prompt_len, 64))
    params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    rng = np.random.RandomState(seed)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)).to(dev)
    enc = None
    if cfg.enc_dec:
        enc = torch.from_numpy(rng.randn(batch, cfg.enc_seq, cfg.d_model)
                               .astype(np.float32)).to(dev)

    t0 = time.time()
    with torch.no_grad():
        logits, cache = zoo.prefill(params, cfg, ctx, prompts,
                                    enc_embeds=enc, max_len=prompt_len + gen)
        tok = zoo.greedy(logits)
        out = [tok]
        for _ in range(gen - 1):
            logits, cache = zoo.decode_step(params, cfg, ctx, tok, cache)
            tok = zoo.greedy(logits)
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu()
        finite = bool(torch.isfinite(logits).all())
    dt = time.time() - t0
    print(f"[serve] {arch}: batch={batch} prompt={prompt_len} gen={gen} "
          f"in {dt:.2f}s ({batch * gen / dt:.1f} tok/s)")
    print("[serve] sample generations (token ids):")
    for b in range(min(batch, 2)):
        print("  ", toks[b][:16].numpy())
    if not finite:
        raise FloatingPointError("non-finite logits")
    return toks


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args.arch, args.reduced, args.batch, args.prompt_len, args.gen,
        device=args.device)


if __name__ == "__main__":
    main()
