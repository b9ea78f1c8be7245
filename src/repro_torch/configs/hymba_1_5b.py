"""Hymba-1.5B: 32L d_model=1600 25H (GQA kv=5) d_ff=5504, parallel attn+mamba
heads, ssm_state=16.

[arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba_1_5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, conv_width=4,
                  n_groups=1, chunk=128),
    sliding_window=1024,  # hymba uses local attn in most layers
    global_every=16,
    rope_theta=10_000.0,
    source="arXiv:2411.13676; hf",
)
