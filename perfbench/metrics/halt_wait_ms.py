"""halt_wait_ms (ms, layer "BSP loop"): the host's wait at a superstep's
halt read for the device work queued after the step's last synchronising
op: the program's ``bsp.halt_read`` spans in the window, summed, over the
number of ``bsp.superstep`` spans; moves evps.  With ``enqueue_ms`` it
makes up the superstep.  Higher is better: it rises as syncs leave the
step and the host runs ahead of the device, the change that shrinks
``enqueue_ms``; read the two together, since in a loop with no sync in
the step a faster device lowers it too."""
from perfbench.harness import spans


def read(run):
    return spans.per(run, "bsp.halt_read", "bsp.superstep", 1e3)
