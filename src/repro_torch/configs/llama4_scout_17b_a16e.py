"""Llama-4-Scout-17B-16E: 48L d_model=5120 40H (GQA kv=8) MoE 16 experts top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4_scout_17b_a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,  # all-MoE FFN
    vocab=202048,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  capacity_factor=1.25, n_mirrored_experts=0),
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
