"""Train a reduced LM for a few hundred steps with checkpointing on the
PyTorch port (the LM side end to end; the counterpart of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch/train_lm.py [steps] \\
        [--ckpt-dir DIR] [--device cpu]

Runs on the card unless ``--device cpu`` is given (``cuda``, the
default, raises without one).  Checkpoints go to a fresh temporary
directory, removed at the end, unless ``--ckpt-dir`` is given (a run
resumes from that directory's latest checkpoint).  ``main`` returns the
losses.
"""
import argparse
import math
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.train import run  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="repro_train_lm_") as tmp:
        losses = run("tinyllama_1_1b", reduced=True, steps=args.steps,
                     batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50, lr=1e-3,
                     device=args.device)
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} "
          "steps")
    assert all(map(math.isfinite, losses)), "the losses must stay finite"
    assert losses[-1] < losses[0], "training must reduce loss"
    return {"losses": losses}


if __name__ == "__main__":
    main()
