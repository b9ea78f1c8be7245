"""Chameleon-34B: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

Early-fusion VLM: VQ image tokens share the text vocab; the VQ tokenizer
frontend is a STUB per the assignment (token ids arrive pre-tokenized).
[arXiv:2405.09818; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon_34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=65536,
    frontend_stub=True,
    rope_theta=10_000.0,
    source="arXiv:2405.09818; unverified",
)
