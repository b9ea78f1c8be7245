"""stats_read_ms (ms, layer "BSP loop"): each job's copy of its stats
totals to the host: the program's ``bsp.stats_read`` spans in the window,
summed, over the number of ``engine.run`` spans (jobs); moves evps."""
from perfbench.harness import spans


def read(run):
    return spans.per(run, "bsp.stats_read", "engine.run", 1e3)
