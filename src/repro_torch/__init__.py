"""PyTorch/CUDA port of the message-reduction and load-balancing graph
engine (the JAX package ``repro`` is its reference).  See ``api.Engine``."""
