"""Core transformer layers: RMSNorm, RoPE, GQA attention (full / sliding /
chunked online-softmax), SwiGLU MLP -- the port of
``repro.models.layers``.

Parameters are plain tensors in the JAX package's layout (``wq`` is
(D, H, hd), ``wo`` (H, hd, D), ...), so a weight carried across from the
reference is used as it is.  Products accumulate in the input type
(float32 for the configs served here; TF32 stays off).

Kernel dispatch (``AttnSpec.kernels``): ``"auto"`` sends a CUDA tensor's
full-sequence attention (causal or windowed self-attention, an encoder's
unmasked self-attention, cross-attention) to the flash attention kernel
and a CPU tensor to the JAX package's own choice of plain attention;
``"kernel"`` always goes through the kernel's wrapper (which launches
the kernel for a CUDA tensor and takes its plain version for a CPU
tensor, so the CPU tests cover the kernel's route); ``"ref"`` always
takes the JAX package's choice.  The kernel's wrapper is differentiable
(its ``autograd.Function``: the kernel forward, a plain backward), so
training takes the same routes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax NaN-free on masked rows
KERNEL_MODES = ("auto", "kernel", "ref")


def use_kernel(mode: str, t: torch.Tensor) -> bool:
    """Whether a model function sends ``t`` to its kernel under ``mode``."""
    if mode == "auto":
        return t.is_cuda
    if mode == "kernel":
        return True
    if mode == "ref":
        return False
    raise ValueError(f"unknown kernel mode {mode!r}; use one of "
                     f"{KERNEL_MODES}")


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Split halves (not
    interleaved), as the reference rotates."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions[..., None].float() * freqs              # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    causal: bool = True
    window: int = 0          # sliding window size; 0 = full
    q_chunk: int = 1024      # online-softmax query-chunking threshold/size
    kernels: str = "auto"    # "auto" | "kernel" | "ref" (module docstring)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(
        b, s, kh * n_rep, hd)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(..., Sq, Sk) additive bias from position vectors."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, NEG_INF)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: AttnSpec, q_pos: torch.Tensor,
              k_pos: torch.Tensor) -> torch.Tensor:
    """Plain attention with grouped-GQA einsums: query heads are reshaped
    to (kv_head, rep), so repeated K/V are never materialised.
    q: (B,Sq,H,hd), k/v: (B,Sk,K,hd)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    r = h // kh
    scale = spec.head_dim ** -0.5
    qg = q.reshape(b, sq, kh, r, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float() * scale
    bias = _mask_bias(q_pos, k_pos, spec.causal, spec.window)
    scores = scores + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      spec: AttnSpec, q_pos: torch.Tensor,
                      k_pos: torch.Tensor) -> torch.Tensor:
    """Online-softmax attention over query chunks: memory
    O(Sq_chunk * Sk) instead of O(Sq * Sk).  The flash attention kernel is
    the tiled version of this loop."""
    b, sq, h, hd = q.shape
    c = min(spec.q_chunk, sq)
    if sq % c:
        return attention(q, k, v, spec, q_pos, k_pos)
    n_rep = spec.n_heads // spec.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = spec.head_dim ** -0.5
    outs = []
    for i in range(sq // c):
        qi = q[:, i * c:(i + 1) * c]
        qpi = q_pos[:, i * c:(i + 1) * c]
        scores = torch.einsum("bqhd,bkhd->bhqk", qi, k).float() * scale
        scores = scores + _mask_bias(qpi, k_pos, spec.causal,
                                     spec.window)[:, None]
        m = torch.amax(scores, dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
        denom = torch.sum(p, dim=-1).transpose(1, 2)[..., None]
        outs.append((o / torch.clamp(denom, min=1e-30)).to(qi.dtype))
    return torch.cat(outs, dim=1)


def attn_qkv(x: torch.Tensor, w: dict, spec: AttnSpec,
             positions: torch.Tensor):
    """Project to rotated q and k, v. w['wq']:(D,H,hd) w['wk'/'wv']:(D,K,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, w["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, w["wv"])
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def attn_block(x: torch.Tensor, w: dict, spec: AttnSpec,
               positions: torch.Tensor, cross_kv=None, cross_pos=None,
               return_kv: bool = False):
    """Full attention sub-block (no cache): qkv + attn + out-proj.

    Self-attention: ``positions`` are 0..S-1 in every row (prefill, the
    full forward and the encoder), which is what the flash kernel's masks
    assume.  Cross-attention (``cross_kv`` = the encoder's (k, v), not
    rotated, at ``cross_pos``): q is projected from ``x`` and rotated at
    ``positions``, and ``spec`` must be unmasked (``causal=False,
    window=0``), so the kernel takes any query positions, one decode
    token's among them.  return_kv=True also returns the rotated (k, v)
    so prefill can build the KV cache."""
    if cross_kv is None:
        q, k, v = attn_qkv(x, w, spec, positions)
        k_pos = positions
    else:
        q = apply_rope(torch.einsum("bsd,dhk->bshk", x, w["wq"]), positions,
                       spec.rope_theta)
        k, v = cross_kv
        k_pos = cross_pos
    if use_kernel(spec.kernels, x):
        o = flash_attention(q, k, v, causal=spec.causal, window=spec.window)
    else:
        impl = attention if x.shape[1] <= spec.q_chunk else chunked_attention
        o = impl(q, k, v, spec, positions, k_pos)
    out = torch.einsum("bshk,hkd->bsd", o, w["wo"])
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode-time attention against a KV cache
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, spec: AttnSpec,
                     pos: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One-token decode. q: (B,1,H,hd); caches: (B,Sc,K,hd); pos: (B,)
    current position (tokens < pos are valid)."""
    n_rep = spec.n_heads // spec.n_kv_heads
    k = _repeat_kv(k_cache, n_rep)
    v = _repeat_kv(v_cache, n_rep)
    scale = spec.head_dim ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    k_idx = torch.arange(k.shape[1], device=q.device).view(1, 1, 1, -1)
    p4 = pos.view(-1, 1, 1, 1)
    valid = k_idx <= p4
    if spec.window > 0:
        valid &= k_idx > (p4 - spec.window)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x: torch.Tensor, w: dict) -> torch.Tensor:
    """w['w_gate'/'w_up']: (D,F), w['w_down']: (F,D)."""
    g = torch.einsum("bsd,df->bsf", x, w["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, w["w_up"])
    return torch.einsum("bsf,fd->bsd", silu(g) * u, w["w_down"])
