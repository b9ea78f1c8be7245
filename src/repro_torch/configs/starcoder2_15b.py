"""StarCoder2-15B: 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.

[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    rope_theta=100_000.0,
    source="arXiv:2402.19173; hf",
)
