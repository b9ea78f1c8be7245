"""window_builds (builds, layer "plans and warm-up"): the plans built or
uploaded and the kernels built inside the window, where none should be:
the program's ``plan.build``, ``plan.upload`` and ``kernels.build`` spans
that began in it; moves evps."""
from perfbench.harness import spans

BUILDS = ("plan.build", "plan.upload", "kernels.build")


def read(run):
    kept, win = spans.record(), spans.window_ns(run)
    if kept is None or win is None:
        return None
    return float(sum(1 for s in kept if s.name in BUILDS
                     and win[0] <= s.start_ns <= win[1]))
