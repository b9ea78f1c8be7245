"""plan_build_s (s, layer "plans and warm-up"): the host's time building the
message plans and uploading them: the program's ``plan.build`` and
``plan.upload`` spans of this run that ended before the window (in the
warm job), summed; moves setup_s."""
from perfbench.harness import spans


def read(run):
    kept, win = spans.record(), spans.window_ns(run)
    if kept is None or win is None or "setup_s" not in run.setup:
        return None
    start = win[0] - int(round(run.setup["setup_s"] * 1e9))
    total = sum(s.end_ns - s.start_ns for s in kept
                if s.name in ("plan.build", "plan.upload")
                and s.start_ns >= start and s.end_ns <= win[0])
    return total / 1e9 if total > 0 else None
