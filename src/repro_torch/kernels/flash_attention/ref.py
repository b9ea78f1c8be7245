"""The plain PyTorch version of the flash attention kernel: the port of
``repro.kernels.flash_attention.ref.flash_attention_ref``.  It repeats the
kv heads and materialises the (BH, Sq, Sk) scores; the tests hold the
kernel and the JAX package against it, and on the card the model runs it
only under the ``"ref"`` kernel mode's comparisons."""
from __future__ import annotations

import torch

NEG = -2.0 ** 30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (BH, Sq, d); k/v: (BKV, Sk, d) with BH % BKV == 0; positions
    start at 0 on both sides.  Scores in float32 (float64 inputs stay
    float64, for an oracle); returns q's dtype."""
    BH, Sq, d = q.shape
    BKV, Sk, _ = k.shape
    n_rep = BH // BKV
    k = torch.repeat_interleave(k, n_rep, dim=0)
    v = torch.repeat_interleave(v, n_rep, dim=0)
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bqd,bkd->bqk", q.to(work), k.to(work)) * d ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    s = torch.where(ok[None], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(work)).to(q.dtype)
