"""BSP superstep runtime (the counterpart of ``repro.core.bsp``): a Python
loop of supersteps with halt voting and per-superstep message accounting.

A *program* is ``step(state, superstep) -> (state, halted, stats)`` where
``state`` is any structure of tensors, ``halted`` a bool scalar tensor (the
paper's "all vertices voted to halt & no pending messages") and ``stats`` a
flat dict of scalar / (M,) tensors.  The loop reads ``halted`` on the host
once per superstep and stops at the first True or after
``max_supersteps``.

Totals are accumulated on the device: integer stats as int64 (torch has
it, so the reference's (hi, lo) int32 limbs are not needed), float stats
in their own dtype.  They are returned as ``repro.core.bsp.finalize_totals``
returns them: Python ints for integer scalars, ``np.int64`` arrays for
integer vectors, numpy arrays for floats.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _finalize(acc: Dict[str, torch.Tensor]) -> Dict[str, object]:
    out = {}
    for k, a in acc.items():
        a = a.cpu().numpy()
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
            out[k] = int(a) if a.ndim == 0 else a
        else:
            out[k] = a
    return out


def run(step: Callable, state, max_supersteps: int,
        record_history: bool = False
        ) -> Tuple[object, Dict, int, Optional[Dict[str, torch.Tensor]]]:
    """Run ``step`` until halt or ``max_supersteps``.

    Returns ``(final_state, stats_totals, n_supersteps, history)``.
    ``history`` is, when ``record_history=True``, a dict of tensors with a
    leading ``max_supersteps`` axis holding each superstep's stats (zeros
    past the last superstep, as in the reference); else None."""
    acc: Dict[str, torch.Tensor] = {}
    hist: Optional[Dict[str, torch.Tensor]] = None
    n = 0
    while n < max_supersteps:
        state, halted, stats = step(state, n)
        if not acc:
            acc = {k: torch.zeros_like(
                v, dtype=(v.dtype if v.dtype.is_floating_point
                          else torch.int64)) for k, v in stats.items()}
            if record_history:
                hist = {k: torch.zeros((max_supersteps,) + tuple(v.shape),
                                       dtype=v.dtype, device=v.device)
                        for k, v in stats.items()}
        for k, v in stats.items():
            acc[k] += v
            if hist is not None:
                hist[k][n] = v
        n += 1
        if bool(halted):            # the one host read of the superstep
            break
    return state, _finalize(acc), n, hist
