"""Serve a small model with batched requests on the PyTorch port: prefill +
KV/SSM-cache decode across three architecture families (dense GQA, MoE,
SSM) -- the counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]

Runs on the card unless ``--device cpu`` is given (``cuda``, the
default, raises without one).  ``main`` returns each arch's generated
tokens.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.serve_model import run  # noqa: E402

ARCHS = ("tinyllama_1_1b", "olmoe_1b_7b", "mamba2_1_3b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)
    out = {arch: run(arch, reduced=True, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen,
                     device=args.device)
           for arch in ARCHS}
    print("\nAll three families served. Done.")
    return out


if __name__ == "__main__":
    main()
