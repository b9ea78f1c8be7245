"""Profiler ranges around the program's entry points, and the reduction of
the device trace to the numbers the metric readers take.

The ranges are put from here, in the benchmark's own process: each named
entry point (``"module:attribute"``) is swapped for a wrapper that opens a
``torch.profiler.record_function`` range around the call.  No file of the
program is edited.  The harness always ranges the BSP loop and the channel
entry points that the cell's algorithm module holds; a metric file adds its
own in ``RANGES`` and may record what each call carries with ``on_call``.

A device operation belongs to a range when the host event that launched it
(its linked correlation id) started inside that range.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "perfbench.window"
JOB = "perfbench.job"
#: the program's BSP loop and the channel layer's entry points, ranged in
#: every traced run (the channels only where the algorithm module holds
#: them)
BASE_RANGES = {"repro_torch.core.bsp:run": "bsp.run"}
CHANNEL_ENTRIES = ("broadcast", "gather", "gather_edges", "scatter_state",
                   "scatter_edges")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclasses.dataclass
class Trace:
    """What one traced window showed.  Times in seconds."""
    window_s: float
    busy_s: float                         # union of device operations
    device_s: float                       # sum of device operations
    range_device_s: Dict[str, float]      # device time launched in a range
    calls: Dict[str, List[dict]]          # per metric: what on_call kept
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Tracer:
    """Patches the ranged entry points while it is installed; ``window()``
    profiles the measured window and leaves the reduced ``trace``."""

    def __init__(self, ranges: Dict[str, str],
                 hooks: Dict[str, Tuple[str, Callable]]):
        # ranges: "module:attr" -> range name; hooks: "module:attr" ->
        # (metric name, on_call(args, kwargs) -> dict)
        self.ranges = ranges
        self.hooks = hooks
        self.on = False
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.trace: Optional[Trace] = None
        self._saved: List[Tuple[object, str, object]] = []

    def _wrap(self, fn, name: str, hook):
        tracer = self

        def ranged(*args, **kwargs):
            if not tracer.on:
                return fn(*args, **kwargs)
            if hook is not None:
                metric, on_call = hook
                tracer.calls[metric].append(on_call(args, kwargs))
            with record_function(name):
                return fn(*args, **kwargs)
        ranged.__wrapped__ = fn
        return ranged

    def install(self) -> None:
        for target, name in self.ranges.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, name, self.hooks.get(target)))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    @contextlib.contextmanager
    def window(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self.on = True
            try:
                with record_function(WINDOW):
                    yield
            finally:
                self.on = False
        self.trace = reduce_events(prof.profiler.kineto_results.events(),
                                   set(self.ranges.values()) | {JOB},
                                   dict(self.calls))


def channel_ranges(algo_module: str) -> Dict[str, str]:
    """The channel entry points an algorithm module calls by name."""
    mod = importlib.import_module(algo_module)
    return {f"{algo_module}:{name}": f"channels.{name}"
            for name in CHANNEL_ENTRIES if hasattr(mod, name)}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _inside(merged: List[Tuple[int, int]], starts: List[int], t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def _activity(e) -> str:
    try:
        return e.activity_type()
    except AttributeError:      # older kineto bindings
        return "kernel"


def reduce_events(events, range_names, calls) -> Trace:
    """Reduce the profiler's raw events: the window, device busy time,
    device time by range and by operation, and idle gaps named by the
    innermost host event open when each began."""
    launch_at: Dict[int, int] = {}
    host = []                    # (start, end, name, thread)
    ranges: Dict[str, list] = defaultdict(list)
    device = []                  # (start, end, name, linked id)
    window = None
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() != 0:
                continue         # runtime calls: their op is the launcher
            s, t = e.start_ns(), e.end_ns()
            name = e.name()
            launch_at[e.correlation_id()] = s
            host.append((s, t, name, e.start_thread_id()))
            if name == WINDOW:
                window = (s, t, e.start_thread_id())
            elif name in range_names:
                ranges[name].append((s, t))
        elif (e.device_type() == DeviceType.CUDA
              and _activity(e) in DEVICE_ACTIVITIES
              and not e.is_user_annotation()):
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), e.name(),
                           e.linked_correlation_id()))
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    ws, we, thread = window
    device = [(max(s, ws), min(t, we), n, c) for s, t, n, c in device
              if t > ws and s < we]
    busy = _merge([(s, t) for s, t, _, _ in device])
    merged = {k: _merge(v) for k, v in ranges.items()}
    starts = {k: [s for s, _ in v] for k, v in merged.items()}
    range_ns: Dict[str, int] = defaultdict(int)
    by_op: Dict[str, int] = defaultdict(int)
    for s, t, name, linked in device:
        by_op[name] += t - s
        at = launch_at.get(linked)
        if at is None:
            continue
        for k, m in merged.items():
            if _inside(m, starts[k], at):
                range_ns[k] += t - s

    # idle gaps inside the window, each named by the innermost host event
    # of the window's thread open when it began
    gaps, prev = [], ws
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if we > prev:
        gaps.append((prev, we))
    host = sorted((s, -t, n) for s, t, n, th in host
                  if th == thread and t > ws and s < we)
    gap_ns: Dict[str, int] = defaultdict(int)
    stack: List[Tuple[int, str]] = []
    i = 0
    for gs, ge in gaps:
        while i < len(host) and host[i][0] <= gs:
            s, neg_t, n = host[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-neg_t, n))
            i += 1
        while stack and stack[-1][0] < gs:
            stack.pop()
        gap_ns[stack[-1][1] if stack else WINDOW] += ge - gs

    def top(d):
        return [[k[:160], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Trace(
        window_s=(we - ws) / 1e9,
        busy_s=sum(t - s for s, t in busy) / 1e9,
        device_s=sum(t - s for s, t, _, _ in device) / 1e9,
        range_device_s={k: v / 1e9 for k, v in range_ns.items()},
        calls=calls, device_ops=top(by_op), idle_gaps=top(gap_ns))
