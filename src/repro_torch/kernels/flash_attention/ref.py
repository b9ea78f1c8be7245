"""The plain PyTorch version of the flash attention kernel: the port of
``repro.kernels.flash_attention.ref.flash_attention_ref``.  It groups the
query heads by their kv head and materialises the (BH, Sq, Sk) scores;
the tests hold the kernel and the JAX package against it, and on the card
the model runs it only under the ``"ref"`` kernel mode's comparisons.

``flash_attention_vjp`` is the kernel's backward: the gradient of this
same function, called on one query chunk at a time at the chunk's
positions, so that no (BH, Sq, Sk) score tensor is ever whole."""
from __future__ import annotations

import torch

NEG = -2.0 ** 30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q0: int = 0, k0: int = 0) -> torch.Tensor:
    """q: (BH, Sq, d); k/v: (BKV, Sk, d) with BH % BKV == 0, query head h
    reading kv head h // (BH // BKV) (the query heads grouped by their kv
    head, not k and v repeated); the query rows sit at positions q0.. and
    the keys at k0.. (both 0 for a whole sequence).  Scores in float32
    (float64 inputs stay float64, for an oracle); returns q's dtype."""
    BH, Sq, d = q.shape
    BKV, Sk, _ = k.shape
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(work).reshape(BKV, BH // BKV, Sq, d)
    s = torch.einsum("grqd,gkd->grqk", qg, k.to(work)) * d ** -0.5
    qp = torch.arange(q0, q0 + Sq, device=q.device)[:, None]
    kp = torch.arange(k0, k0 + Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    s = torch.where(ok, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("grqk,gkd->grqd", p, v.to(work))
    return o.reshape(BH, Sq, d).to(q.dtype)


# float32 scores of one query chunk in the backward: 2^25 (128 MiB), of
# which autograd keeps a few copies at a time
VJP_CHUNK_ELEMS = 2 ** 25


def vjp_chunk_rows(BH: int, Sq: int, Sk: int) -> int:
    """Query rows of one chunk of ``flash_attention_vjp``."""
    return max(1, min(Sq, VJP_CHUNK_ELEMS // max(BH * Sk, 1)))


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, chunk: int = 0):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v)`` for the upstream
    gradient ``do`` (BH, Sq, d): autograd of the plain function, recomputed
    for ``chunk`` query rows at a time (``vjp_chunk_rows`` by default),
    each chunk against only the keys its mask can keep (below its last
    row when causal, within the window of its first); a dropped key's
    weight is exactly 0, so this is the same function.  dk and dv sum the
    chunks and the n_rep query heads that share a kv head, in float32
    (float64 for float64), and come back in k's dtype."""
    BH, Sq, d = q.shape
    BKV, Sk, _ = k.shape
    c = chunk or vjp_chunk_rows(BH, Sq, Sk)
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=work, device=k.device)
    dv = torch.zeros(v.shape, dtype=work, device=v.device)
    q, k, v = q.detach(), k.detach(), v.detach()
    for i0 in range(0, Sq, c):
        i1 = min(Sq, i0 + c)
        hi = min(Sk, i1) if causal else Sk
        lo = max(0, i0 - window + 1) if window > 0 else 0
        with torch.enable_grad():
            qc = q[:, i0:i1].requires_grad_(True)
            kc = k[:, lo:hi].requires_grad_(True)
            vc = v[:, lo:hi].requires_grad_(True)
            o = flash_attention_ref(qc, kc, vc, causal=causal,
                                    window=window, q0=i0, k0=lo)
            gq, gk, gv = torch.autograd.grad(o, (qc, kc, vc),
                                             do[:, i0:i1])
        dq[:, i0:i1] = gq
        dk[:, lo:hi] += gk
        dv[:, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)
