"""Per-worker message counting: the channels' (M,) tally kernel."""
