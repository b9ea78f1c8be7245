"""superstep_ms (ms, layer "BSP loop"): the window's job time over the
supersteps its jobs ran (``RunResult.n_supersteps`` summed); moves evps."""


def read(run):
    steps = sum(j.n_supersteps for j in run.jobs)
    if steps == 0:
        return None
    return 1e3 * sum(j.seconds for j in run.jobs) / steps
