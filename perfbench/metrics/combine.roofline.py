"""combine.roofline (%, layer "plan combine and kernel"): the plan
combine's logical bytes over the device time of every operation launched
inside ``plan.combine_with_plan``, against the card's HBM bandwidth from
``peaks.json``; moves evps.

The bytes come from the plan's shapes and the payload, each input read
once and each output written once, whatever an implementation reads
again; so any implementation of the same combine is held to them:

* each lane of the plan (rows x entries a row): its flat edge index and
  its slot in the destination block, 4 bytes each as the plan stores them;
* each row's segment and each segment's block, 4 bytes each;
* each edge's value, read once (E x features x payload size);
* the inbox, written once (M_dst x n_loc x features x payload size);
* where the call counts messages: each edge's send flag (1 byte), each
  segment's source worker (4 bytes) and the counts written (8 bytes for
  the total and for each worker).
"""
import json
from pathlib import Path

RANGES = {"repro_torch.core.plan:combine_with_plan":
          "plan.combine_with_plan"}
INDEX = 4


def on_call(args, kwargs) -> int:
    plan, vals = args[0], args[1]
    count = kwargs.get("count_cross", args[3] if len(args) > 3 else True)
    m_out = kwargs.get("M_out") or plan.M_src
    if hasattr(vals, "n_edges"):             # a feature-blocked EdgeMap
        edges, feat = vals.n_edges, vals.feat
    else:
        edges = vals.shape[0]
        feat = vals.shape[1] if vals.dim() == 2 else 1
    item = vals.dtype.itemsize
    lanes = plan.n_rows * plan.eb
    nbytes = (lanes * 2 * INDEX + plan.n_rows * INDEX + plan.n_segs * INDEX
              + edges * feat * item + plan.M_dst * plan.n_loc * feat * item)
    if count:
        nbytes += edges + plan.n_segs * INDEX + (m_out + 1) * 8
    return nbytes


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds = t.range_device_s.get("plan.combine_with_plan", 0.0)
    calls = t.calls.get("combine.roofline", [])
    peaks = json.loads((Path(__file__).resolve().parents[1]
                        / "peaks.json").read_text())
    peak = peaks.get(run.device_kind, {}).get("hbm_bytes_per_s")
    if seconds <= 0 or not calls or peak is None:
        return None
    return 100.0 * sum(calls) / peak / seconds
