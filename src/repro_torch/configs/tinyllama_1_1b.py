"""TinyLlama-1.1B: 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.

[arXiv:2401.02385; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama_1_1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    rope_theta=10_000.0,
    source="arXiv:2401.02385; hf",
)
