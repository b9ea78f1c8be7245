"""End-to-end graph analytics over all paper workloads on the
PyTorch port (the counterpart of ``examples/graph_analytics.py``): the
paper-kind production scenario (CC + MSF + PageRank + SSSP on one graph
corpus, with channel configuration and balance reporting) -- everything
through the ``repro_torch.api.Engine`` front door.

    PYTHONPATH=src python examples/torch/graph_analytics.py [scale] \\
        [--device cpu]

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
from repro_torch.core.cost_model import straggler_report  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402


def host(x) -> np.ndarray:
    """A result's tensor, or a host array already, as a numpy array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scale", nargs="?", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)
    M = 16

    g = gen.powerlaw(args.scale, avg_deg=8, alpha=1.8, seed=0,
                     weighted=True).symmetrized()
    tau = choose_tau(g.out_degrees(), M)
    eng = Engine(device=args.device)   # dense backend, padded layout
    pg = eng.partition(g, M, tau=tau, seed=0)
    print(f"corpus: n={g.n} m={g.m} tau*={tau} M={M}")
    out = {"n": g.n, "m": g.m, "tau": tau}

    print("\n-- connected components (Hash-Min, mirrored) --")
    res = eng.run("hashmin", pg)
    per_worker = host(res.stats["per_worker_total"])
    rep = straggler_report(per_worker)
    out["hashmin"] = {"supersteps": res.n_supersteps,
                      "msgs_total": int(res.stats["msgs_total"]),
                      "per_worker_total": per_worker.tolist(),
                      "labels": host(res.state)}
    print(f"supersteps={res.n_supersteps} "
          f"msgs={out['hashmin']['msgs_total']:,} "
          f"balance max/mean={rep['max_over_mean']:.2f}")

    print("\n-- connected components (S-V, request-respond) --")
    res = eng.run("sv", pg)
    rr, basic = int(res.stats["msgs_rr"]), int(res.stats["msgs_basic"])
    out["sv"] = {"supersteps": res.n_supersteps, "msgs_rr": rr,
                 "msgs_basic": basic,
                 "per_worker_rr": host(res.stats["per_worker_rr"]).tolist(),
                 "per_worker_basic": host(
                     res.stats["per_worker_basic"]).tolist(),
                 "labels": host(res.state)}
    print(f"rounds={res.n_supersteps} rr={rr:,} basic={basic:,} "
          f"({basic / max(rr, 1):.2f}x reduction)")

    print("\n-- PageRank (10 iters) --")
    res = eng.run("pagerank", pg, n_iters=10, tol=0.0)
    pr = host(res.state).reshape(-1)
    top = np.argsort(-pr)[:5]
    out["pagerank"] = {"supersteps": res.n_supersteps,
                       "msgs_total": int(res.stats["msgs_total"]),
                       "state": pr}
    print(f"msgs={out['pagerank']['msgs_total']:,} top-5 pr={pr[top]}")

    print("\n-- SSSP from vertex 0 (relay() on mirrors) --")
    res = eng.run("sssp", pg, source=int(host(pg.perm)[0]))
    d = host(res.state).reshape(-1)
    out["sssp"] = {"supersteps": res.n_supersteps,
                   "msgs_total": int(res.stats["msgs_total"]),
                   "reached": int(np.isfinite(d).sum()), "state": d}
    print(f"supersteps={res.n_supersteps} "
          f"msgs={out['sssp']['msgs_total']:,} "
          f"reached={out['sssp']['reached']}/{pg.n_pad}")

    print("\n-- minimum spanning forest (Boruvka + SEAS) --")
    res = eng.run("msf", pg)
    labels, total_w, n_edges = res.state
    out["msf"] = {"supersteps": res.n_supersteps, "edges": int(n_edges),
                  "weight": float(total_w),
                  "msgs_rr": int(res.stats["msgs_rr"]),
                  "msgs_basic": int(res.stats["msgs_basic"]),
                  "labels": host(labels)}
    print(f"rounds={res.n_supersteps} |MSF|={out['msf']['edges']} "
          f"weight={out['msf']['weight']:.1f} "
          f"rr={out['msf']['msgs_rr']:,} "
          f"basic={out['msf']['msgs_basic']:,}")
    print("\nDone.")
    return out


if __name__ == "__main__":
    main()
