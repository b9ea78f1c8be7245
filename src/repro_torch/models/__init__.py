"""Models of the port: node embeddings and the softmax loss (GCN), and the
LM stack (layers, the Mamba-2 mixer, the MoE FFN with expert parallelism,
the stage-structured transformer and the model zoo) for the dense, ssm,
hybrid and moe stage kinds."""
