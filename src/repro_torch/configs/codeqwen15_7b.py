"""CodeQwen1.5-7B: 32L d_model=4096 32H (kv=32, MHA) d_ff=13440 vocab=92416.

[hf:Qwen/CodeQwen1.5-7B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen15_7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)
