"""Quickstart on the PyTorch port: the paper's two techniques in 40 lines
(the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [scale] [--device cpu]

Runs on the card unless ``--device cpu`` is given (``cuda``, the
default, raises without one).  ``main`` returns the printed numbers.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402

from repro_torch.api import Engine  # noqa: E402
from repro_torch.core.cost_model import choose_tau  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402


def host(x) -> np.ndarray:
    """A result's tensor, or a host array already, as a numpy array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scale", nargs="?", type=int, default=20_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)

    # A skewed graph: a few vertices have enormous degree (BTC/Twitter-like).
    g = gen.powerlaw(args.scale, avg_deg=8, alpha=1.8, seed=0).symmetrized()
    M = 16
    deg = g.out_degrees()
    tau = choose_tau(deg, M)
    print(f"graph: n={g.n} m={g.m} max_deg={deg.max()} "
          f"avg_deg={deg.mean():.1f}")
    print(f"Theorem-2 mirroring threshold: tau* = M*exp(deg_avg/M) = {tau}")

    # --- Technique 1: mirroring (high-degree vertices) -------------------
    eng = Engine(device=args.device)
    pg = eng.partition(g, M, tau=tau, seed=0)
    res = eng.run("hashmin", pg)
    res_nom = Engine(device=args.device, use_mirroring=False).run(
        "hashmin", pg)
    stats, stats_nom = res.stats, res_nom.stats
    out = {"n": g.n, "m": g.m, "tau": tau,
           "hashmin_supersteps": res.n_supersteps,
           "hashmin_nom_supersteps": res_nom.n_supersteps,
           "msgs_basic": int(stats_nom["msgs_basic"]),
           "msgs_combined": int(stats_nom["msgs_combined"]),
           "msgs_total": int(stats["msgs_total"])}
    print(f"\nHash-Min CC in {res.n_supersteps} supersteps")
    print(f"  messages, Pregel basic (no combiner): {out['msgs_basic']:>12,}")
    print(f"  messages, with combiner (Pregel-noM): "
          f"{out['msgs_combined']:>12,}")
    print(f"  messages, combiner + mirroring:       {out['msgs_total']:>12,}")

    # --- Technique 2: request-respond (algorithm-logic bottlenecks) ------
    res2 = eng.run("sv", pg)
    stats2 = res2.stats
    out.update(sv_rounds=res2.n_supersteps,
               sv_msgs_basic=int(stats2["msgs_basic"]),
               sv_msgs_rr=int(stats2["msgs_rr"]))
    print(f"\nS-V CC in {res2.n_supersteps} rounds (O(log n), pointer "
          "jumping)")
    print(f"  messages, Pregel basic:    {out['sv_msgs_basic']:>12,}")
    print(f"  messages, request-respond: {out['sv_msgs_rr']:>12,}")
    per = host(stats2["per_worker_basic"])
    per_rr = host(stats2["per_worker_rr"])
    out["per_worker_basic"] = per.tolist()
    out["per_worker_rr"] = per_rr.tolist()
    print(f"  worker balance (max/mean): basic {per.max() / per.mean():.2f} "
          f"-> rr {per_rr.max() / per_rr.mean():.2f}")
    labels = host(res.state)
    labels2 = host(res2.state)
    # on the real vertices: the padding slots hold each algorithm's own
    # filler (the reference's assert compares those too, and fails at
    # scales whose partition has padding, such as 3000)
    real = host(pg.vmask)
    assert (labels == labels2)[real].all(), "CC labels agree"
    out["labels"], out["sv_labels"] = labels, labels2
    print("\nHash-Min and S-V agree on all component labels. Done.")
    return out


if __name__ == "__main__":
    main()
