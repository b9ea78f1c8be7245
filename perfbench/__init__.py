"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``); see
``perfbench/README.md``."""
