"""job_ms.p90 (ms, end to end, host clock): the 90th percentile (nearest
rank) of every job's time in the window, from the call to the job's final
host read.  Reported only where the window holds at least 100 jobs, so
that at least 10 lie beyond it."""
import math

MIN_JOBS = 100


def read(run):
    if len(run.jobs) < MIN_JOBS:
        return None
    ms = sorted(j.seconds * 1e3 for j in run.jobs)
    return ms[math.ceil(0.9 * len(ms)) - 1]
