"""enqueue_ms (ms, layer "BSP loop"): the host's time from a superstep's
start to the step's return, with the stats' accumulation: the program's
``bsp.enqueue`` spans in the window, summed, over the number of
``bsp.superstep`` spans; moves evps.  It holds the launches and every
wait on the device at a synchronising op inside the step (a ``bincount``
that sizes its output from its input), so it is not the host's issue time
alone.  Read from the program's own record (``repro_torch.tracing``),
which keeps these spans in the traced window."""
from perfbench.harness import spans


def read(run):
    return spans.per(run, "bsp.enqueue", "bsp.superstep", 1e3)
