"""Mamba2-1.3B: 48L d_model=2048, attention-free SSD, ssm_state=128.

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2_1_3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_width=4,
                  n_groups=1, chunk=128),
    source="arXiv:2405.21060; unverified",
)
