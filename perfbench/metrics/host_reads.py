"""host_reads (reads/job, layer "BSP loop"): the host reads of the device
a job makes, the mean over the window's ``engine.run`` spans of the
program's counter ``host_reads`` over each (one a superstep's halt read,
one each stats total copied, one each of MSF's jump reads); moves evps."""
from perfbench.harness import spans


def read(run):
    jobs = spans.inside(run, ("engine.run",))
    if not jobs:
        return None
    return sum(s.attrs.get("counts", {}).get("host_reads", 0)
               for s in jobs) / len(jobs)
