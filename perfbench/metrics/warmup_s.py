"""warmup_s (s, layer "plans and warm-up"): host clock around the untimed
warm job, which builds the plans and grows the caching allocator; moves
setup_s."""


def read(run):
    return run.setup.get("warmup_s")
