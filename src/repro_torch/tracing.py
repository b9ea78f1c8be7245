"""Host spans and counters inside the port.

    from repro_torch import tracing

    with tracing.span("bsp.superstep"):          # a loop span
        ...
    @tracing.traced("channels.gather")            # each call a loop span
    def gather(...): ...
    with tracing.setup_span("plan.build", kind="eg"):   # a set-up span
        ...
    tracing.count("host_reads")

    tracing.record()      # the kept spans, oldest first
    tracing.counters()    # {counter: total}
    tracing.summary()     # {name: {"count", "total_s", "self_s"}}

Two kinds of span:

* **Loop spans** (``span``) sit on the paths every job runs: the BSP loop,
  the channels, the plan combines.  They are kept only while a
  ``torch.profiler`` records; otherwise a loop span costs one check of the
  profiler's flag and does nothing else.
* **Set-up spans** (``setup_span``) cover work whose number is bounded by
  the partitions, plans and kernels a process builds, not by its jobs:
  they are always kept.

While a profiler records, a kept span is also opened as a
``record_function`` range of the same name, so it lands in the profiler's
trace on the clock of the device events (``export_chrome_trace`` is the
exporter).  Each kept span is a ``Span``: its times on
``time.perf_counter_ns``, its id, the id of the span that was open when it
began on the same thread, and the id of the enclosing ``engine.run`` span
(``job_id``), so every span of one job carries the same job.  The record
is a ring of ``RING`` spans; the counter ``tracing.dropped`` counts what
it evicted.

Counters are plain integers, always on.  The ``engine.run`` span carries
the counters' changes over its interval in ``attrs["counts"]``.

No span or counter reads the device, synchronises or allocates on it:
they touch host clocks and Python objects only.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

#: spans the record keeps, newest last; older ones are evicted
RING = 2 ** 20
#: the span whose interval is one job; its id is each inner span's job_id
JOB = "engine.run"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    job_id: Optional[int]
    attrs: dict


_RECORD: collections.deque = collections.deque(maxlen=RING)
_COUNTS: Dict[str, int] = {}
_IDS = itertools.count(1)
_local = threading.local()


class _Null:
    """What a loop span is outside a profiler: a context that does
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Kept:
    """A span that is recorded: its interval, parent and job, and a
    profiler range of its name while a profiler records."""
    __slots__ = ("name", "attrs", "span_id", "parent_id", "job_id",
                 "start_ns", "range", "before")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _stack()
        parent = st[-1] if st else None
        self.span_id = next(_IDS)
        self.parent_id = parent.span_id if parent is not None else None
        self.job_id = (self.span_id if self.name == JOB else
                       parent.job_id if parent is not None else None)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        self.before = dict(_COUNTS) if self.name == JOB else None
        st.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        attrs = self.attrs
        if self.before is not None:
            before = self.before
            attrs = dict(attrs, counts={
                k: v - before.get(k, 0) for k, v in _COUNTS.items()
                if v != before.get(k, 0)})
        if len(_RECORD) == _RECORD.maxlen:
            count("tracing.dropped")
        _RECORD.append(Span(self.name, self.start_ns, end, self.span_id,
                            self.parent_id, self.job_id, attrs))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, /, **attrs):
    """A loop span: kept, and opened as a profiler range, only while a
    ``torch.profiler`` records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Kept(name, attrs)


def traced(name: str):
    """Decorate a function so that each call is the loop span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Kept(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def setup_span(name: str, /, **attrs):
    """A set-up span: always kept; a profiler range too while a profiler
    records."""
    return _Kept(name, attrs)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + k


def counters() -> Dict[str, int]:
    """Every counter's total so far."""
    return dict(_COUNTS)


def record() -> List[Span]:
    """The kept spans, oldest first (at most ``RING``)."""
    return list(_RECORD)


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summary(since_ns: Optional[int] = None, until_ns: Optional[int] = None
            ) -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "total_s", "self_s"}}`` over the kept spans that
    lie in ``[since_ns, until_ns]``.  A span's self time is its duration
    less the union of its children's intervals."""
    spans = [s for s in _RECORD
             if (since_ns is None or s.start_ns >= since_ns)
             and (until_ns is None or s.end_ns <= until_ns)]
    children: Dict[int, list] = collections.defaultdict(list)
    for s in spans:
        if s.parent_id is not None:
            children[s.parent_id].append((s.start_ns, s.end_ns))
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        d = s.end_ns - s.start_ns
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += d / 1e9
        row["self_s"] += (d - _union_ns(children.get(s.span_id, ()))) / 1e9
    return out
