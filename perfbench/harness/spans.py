"""The program's own spans and counters over a run's window, for the
metric readers that read them (``repro_torch.tracing``).

The record is the run's own process's: the program keeps its set-up spans
always and its loop spans while a profiler records, which in a run is the
traced window.  The window is ``[first job's start, last job's end]`` on
the ``perf_counter`` clock, the clock of the spans.  Every function here
returns None where the program has no such record (a checkout without
``repro_torch.tracing``) or the window no job.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def record():
    """The program's kept spans, or None where it keeps none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.record()


def window_ns(run) -> Optional[Tuple[int, int]]:
    if not run.jobs:
        return None
    return (int(round(run.jobs[0].start * 1e9)),
            int(round(run.jobs[-1].end * 1e9)))


def inside(run, names: Iterable[str]) -> Optional[List]:
    """The spans of ``names`` that lie wholly in the window."""
    spans, win = record(), window_ns(run)
    if spans is None or win is None:
        return None
    names = set(names)
    return [s for s in spans if s.name in names
            and win[0] <= s.start_ns and s.end_ns <= win[1]]


def per(run, span: str, unit: str, scale: float = 1.0) -> Optional[float]:
    """The window's total time in ``span`` over the number of ``unit``
    spans, times ``scale`` (seconds to the metric's unit)."""
    kept = inside(run, (span, unit))
    if not kept:
        return None
    units = sum(1 for s in kept if s.name == unit)
    if units == 0:
        return None
    total = sum(s.end_ns - s.start_ns for s in kept if s.name == span)
    return scale * total / 1e9 / units
