"""Training on the graph engine: the optimizer and the GCN."""
