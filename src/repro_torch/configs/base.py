"""Architecture & shape configuration system (the port's own copy of
``repro.configs.base``: plain dataclasses, no JAX).

Every assigned architecture is a frozen ``ArchConfig``; the port's model
zoo (``repro_torch.models.model_zoo``) turns a config into parameters and
the prefill / decode entry points, and the launchers select them with
``--arch <id>``.  ``reduced()`` returns a small-but-same-family config for
CPU tests; ``chip_smoke.py`` serves the full Hymba-1.5B on the card.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # Paper technique (mirroring, Thm 2 analog): replicate the n hottest
    # experts on every EP rank so their traffic never crosses the network.
    n_mirrored_experts: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 0
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    # Sliding-window pattern: window size (0 = full attention everywhere);
    # every ``global_every``-th layer (1-indexed) is global.
    sliding_window: int = 0
    global_every: int = 0
    # Encoder-decoder (whisper): n_enc_layers encoder layers over enc_seq
    # precomputed frame embeddings (conv frontend is a stub per assignment).
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0
    # Modality stub: inputs may be precomputed embeddings (audio frames /
    # VQ image-token embeddings) instead of token ids.
    frontend_stub: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    source: str = ""

    # ---- derived -----------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.moe.n_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim

    def padded_vocab(self, model_parallel: int) -> int:
        """Vocab padded so the embedding shards evenly on the model axis."""
        return _round_up(self.vocab, max(model_parallel, 128))

    @property
    def supports_long_context(self) -> bool:
        """True iff decode state is sub-quadratic in context (SSM state or
        sliding-window cache) -- gates the ``long_500k`` cell."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def shape_supported(self, shape: ShapeConfig) -> Tuple[bool, str]:
        if shape.name == "long_500k" and not self.supports_long_context:
            return False, (
                "pure full-attention arch: 500k dense KV has no sub-"
                "quadratic mode (documented skip, DESIGN.md §Arch)"
            )
        return True, ""

    # ---- params accounting (roofline MODEL_FLOPS) --------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        D, F, L = self.d_model, self.d_ff, self.n_layers
        H, K, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        dense_mlp = 3 * D * F if F else 0
        per_layer = attn + dense_mlp + 2 * D
        total = 0
        active = 0
        if self.family == "ssm":
            zxbcdt = 2 * self.d_inner + 2 * self.ssm.n_groups * self.ssm.d_state + self.n_ssm_heads
            per_layer = D * zxbcdt + self.d_inner * D + 3 * self.n_ssm_heads + 2 * D
            total = active = L * per_layer
        elif self.is_moe:
            e = self.moe
            expert = 3 * D * e.d_ff_expert
            router = D * e.n_experts
            per_layer = attn + router + 2 * D
            total = L * (per_layer + e.n_experts * expert)
            active = L * (per_layer + e.top_k * expert)
        else:
            if self.is_hybrid:
                zxbcdt = 2 * self.d_inner + 2 * self.ssm.n_groups * self.ssm.d_state + self.n_ssm_heads
                per_layer += D * zxbcdt + self.d_inner * D + 3 * self.n_ssm_heads
            total = active = L * per_layer
            if self.enc_dec:
                # decoder cross-attention + encoder stack
                total += self.n_enc_layers * per_layer + L * (2 * D * K * hd + D * H * hd + H * hd * D)
                active = total
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        return {"total": total + emb, "active": active + emb,
                "body_total": total, "body_active": active}

    # ---- smoke-test reduction ----------------------------------------
    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            sliding_window=16 if self.sliding_window else 0,
            global_every=self.global_every if self.sliding_window else 0,
            enc_dec=self.enc_dec,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16 if self.enc_dec else 0,
            frontend_stub=self.frontend_stub,
            norm_eps=self.norm_eps,
            rope_theta=self.rope_theta,
            source="smoke",
        )
        if self.is_moe:
            kw["moe"] = MoEConfig(n_experts=4, top_k=min(self.moe.top_k, 2),
                                  d_ff_expert=64,
                                  n_mirrored_experts=self.moe.n_mirrored_experts and 1)
        if self.ssm.d_state:
            kw["ssm"] = SSMConfig(d_state=8, expand=2, head_dim=16, chunk=8)
        return ArchConfig(**kw)


ARCH_IDS = [
    "llama4_scout_17b_a16e",
    "olmoe_1b_7b",
    "gemma3_4b",
    "starcoder2_15b",
    "codeqwen15_7b",
    "tinyllama_1_1b",
    "whisper_medium",
    "mamba2_1_3b",
    "hymba_1_5b",
    "chameleon_34b",
]

# CLI aliases (hyphenated ids from the assignment sheet).
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "mamba2-1.3b": "mamba2_1_3b",
    "hymba-1.5b": "hymba_1_5b",
})


def get_config(arch: str) -> ArchConfig:
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
