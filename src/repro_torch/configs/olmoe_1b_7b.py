"""OLMoE-1B-7B: 16L d_model=2048 16H (kv=16) MoE 64 experts top-8 d_ff_e=1024.

[arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe_1b_7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                  capacity_factor=1.25, n_mirrored_experts=0),
    rope_theta=10_000.0,
    source="arXiv:2409.02060; hf",
)
