"""partition_s (s, layer "host set-up"): host clock around
``Engine.partition``, synchronised; moves setup_s."""


def read(run):
    return run.setup.get("partition_s")
