"""Deterministic synthetic data pipeline: the counterpart of
``repro.train.data``, in numpy (no JAX, no torch).

Zipf-distributed token streams (the skew that makes the request-respond
embedding lookup matter), deterministic per (seed, step, shard) so that a
restarted run reproduces the exact batch sequence: the data side of the
fault-tolerance contract.  Sharded reads: each data-parallel rank draws
only its slice.  Every batch is bitwise the reference's for the same
(seed, step, shard).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.2
    seed: int = 0


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


class SyntheticLM:
    """Stateless batch oracle: ``batch_at(step)`` is pure in (cfg, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab, cfg.zipf_a)
        self._cum = np.cumsum(self._probs)   # inverse-CDF sampling

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """{"tokens": (global_batch / n_shards, seq_len) int32}: rows
        [shard * b, (shard + 1) * b) of the step's global batch."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {n_shards} shards")
        b_loc = cfg.global_batch // n_shards
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step) % (2 ** 31 - 1))
        u = rng.rand(cfg.global_batch, cfg.seq_len)
        tokens = np.searchsorted(self._cum, u).astype(np.int32)
        tokens = np.clip(tokens, 0, cfg.vocab - 1)
        return {"tokens": tokens[shard * b_loc:(shard + 1) * b_loc]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def token_stats(tokens: np.ndarray) -> Dict[str, float]:
    """Dedup statistics: how much the request-respond embedding lookup
    saves (the paper's metric carried over: distinct requests / total
    requests)."""
    flat = tokens.reshape(-1)
    uniq = len(np.unique(flat))
    return {"tokens": int(flat.size), "unique": int(uniq),
            "dedup_ratio": uniq / flat.size}
