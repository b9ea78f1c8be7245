"""Gemma-3-4B: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    sliding_window=1024,
    global_every=6,  # every 6th layer is global => 5:1 local:global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
