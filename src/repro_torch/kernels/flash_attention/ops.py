"""Model layout adapter: (B, S, H, hd) <-> the kernel's (BH, S, d), the
port of ``repro.kernels.flash_attention.ops.flash_attention``."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    use_kernel: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, K, hd).  Returns (B, Sq, H, hd).

    Row b*H + h of the flattened q maps to kv row b*K + h // (H/K):
    exactly the kernel's ``bh // n_rep``, so GQA repeats are never
    materialised.  ``use_kernel=False`` takes the plain version."""
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * K, Sk, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * K, Sk, hd).contiguous()
    fn = flash_attention_bhsd if use_kernel else flash_attention_ref
    o = fn(qf, kf, vf, causal=causal, window=window)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
