"""Whisper-medium: enc-dec, 24L(+24L enc) d_model=1024 16H d_ff=4096 vocab=51865.

Conv audio frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings of shape (batch, enc_seq, d_model).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    enc_dec=True,
    n_enc_layers=24,
    enc_seq=1500,
    frontend_stub=True,
    rope_theta=10_000.0,
    source="arXiv:2212.04356; unverified",
)
