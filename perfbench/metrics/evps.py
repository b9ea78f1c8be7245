"""evps (EV/s, end to end, host clock): Graphalytics' edges-and-vertices
per second as a rate over the window: (n + arcs) times the jobs completed,
over the time from the first job's start to the last job's end."""


def read(run):
    if not run.jobs:
        return None
    span = run.jobs[-1].end - run.jobs[0].start
    return (run.n + run.arcs) * len(run.jobs) / span
