"""setup_s (s, end to end, host clock): from the process's start to the
first timed job: imports, CUDA start, the kernels' library load,
generation, the partition and the warm job."""


def read(run):
    return run.setup.get("setup_s")
