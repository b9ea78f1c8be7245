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

Tensor parallelism (``group``: the mesh's model group, given where the
block's leaves are split): each rank holds its heads of ``wq`` / ``wo``
(and of ``wk`` / ``wv`` where the kv heads split too, else the whole
leaves, of which it takes the kv heads its query heads read), or its d_ff
columns of ``w_gate`` / ``w_up`` and rows of ``w_down``.  The block's
input enters through ``sum_cotangents`` (each rank's products give only
part of its gradient) and the row-parallel output through
``psum_replicated``.  A block whose leaves stay whole gets no group and
computes the replicated result, not summed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import collectives as coll

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


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """A rank's part of an attention block under tensor parallelism:
    ``spec`` with the rank's head counts, the first of its query heads
    (``h0``), and the run of kv heads its query heads read from whole
    ``wk`` / ``wv`` leaves (``kv``, a slice; None where the kv heads split
    too or nothing splits)."""
    spec: AttnSpec
    group: object = None
    h0: int = 0
    kv: Optional[slice] = None

    def take_kv(self, t: torch.Tensor) -> torch.Tensor:
        """The kv heads of a (B, S, K, hd) tensor that this rank reads."""
        return t if self.kv is None else t[:, :, self.kv]


def head_shard(w: dict, spec: AttnSpec, group=None) -> HeadShard:
    """The rank's heads from its ``wq`` / ``wk`` leaves against the whole
    counts of ``spec``.  Query head h reads kv head h // (H / K): where the
    kv heads stay whole, a rank's query heads read a contiguous run of
    them, H / mp / (H / K) heads, or one kv head shared with other ranks
    when H / mp divides H / K."""
    H, K = spec.n_heads, spec.n_kv_heads
    h_loc, k_loc = w["wq"].shape[-2], w["wk"].shape[-2]
    if group is None or coll.group_size(group) == 1 or h_loc == H:
        return HeadShard(spec)
    h0 = dist.get_rank(group) * h_loc
    kv = None
    if k_loc == K:
        n_rep = H // K
        if h_loc % n_rep and n_rep % h_loc:
            raise NotImplementedError(f"{h_loc} query heads a rank over kv "
                                      f"groups of {n_rep}")
        kv = slice(h0 // n_rep, -(-(h0 + h_loc) // n_rep))
        k_loc = kv.stop - kv.start
    return HeadShard(dataclasses.replace(spec, n_heads=h_loc,
                                         n_kv_heads=k_loc), group, h0, kv)


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
               return_kv: bool = False, group=None):
    """Full attention sub-block (no cache): qkv + attn + out-proj.

    Self-attention: ``positions`` are 0..S-1 in every row (prefill, the
    full forward and the encoder), which is what the flash kernel's masks
    assume.  Cross-attention (``cross_kv`` = the encoder's (k, v), not
    rotated, at ``cross_pos``): q is projected from ``x`` and rotated at
    ``positions``, and ``spec`` must be unmasked (``causal=False,
    window=0``), so the kernel takes any query positions, one decode
    token's among them.  return_kv=True also returns the rotated (k, v)
    as projected (this rank's kv heads, or all of them where ``wk`` is
    whole) so prefill can build the KV cache.

    ``group``: the model group where ``wq`` / ``wo`` hold this rank's
    heads (module docstring); ``cross_kv`` then holds the kv heads of
    this rank's ``wk`` / ``wv``."""
    tp = head_shard(w, spec, group)
    if tp.group is not None:
        x = coll.sum_cotangents(x, tp.group)
    if cross_kv is None:
        q, k, v = attn_qkv(x, w, spec, positions)
        k_pos = positions
    else:
        q = apply_rope(torch.einsum("bsd,dhk->bshk", x, w["wq"]), positions,
                       spec.rope_theta)
        k, v = cross_kv
        k_pos = cross_pos
    ka, va, spec = tp.take_kv(k), tp.take_kv(v), tp.spec
    if use_kernel(spec.kernels, x):
        o = flash_attention(q, ka, va, causal=spec.causal,
                            window=spec.window)
    else:
        impl = attention if x.shape[1] <= spec.q_chunk else chunked_attention
        o = impl(q, ka, va, spec, positions, k_pos)
    out = torch.einsum("bshk,hkd->bsd", o, w["wo"])
    if tp.group is not None:
        out = coll.psum_replicated(out, tp.group)
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


def decode_attention_split(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor,
                           scale: float,
                           seq_group: Optional[object]) -> torch.Tensor:
    """One-token decode against this rank's block of a cache whose
    sequence axis is split over ``seq_group`` (flash-decode): q (B, 1, H,
    hd) all heads; k / v (B, Sc_loc, H, hd), the kv heads already repeated
    to the query heads; valid (B, Sc_loc).  Each rank scores its slots
    (invalid ones the finite NEG_INF), the row max is all-reduced (max)
    over the group, and each rank's exp-weighted value sum and weight
    sum, taken against that max, are all-reduced (sum) together: a block
    with no valid slot weighs exp(NEG_INF - max) = 0.  Returns (B, 1, H,
    hd), replicated over the group."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = coll.psum_replicated(torch.amax(scores, dim=-1, keepdim=True),
                             seq_group, dist.ReduceOp.MAX)
    p = torch.exp(scores - m)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    l_ = torch.sum(p, dim=-1).transpose(1, 2)[..., None]    # (B, 1, H, 1)
    both = coll.psum_replicated(torch.cat([o, l_], dim=-1), seq_group)
    return (both[..., :-1] / both[..., -1:]).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x: torch.Tensor, w: dict, group=None) -> torch.Tensor:
    """w['w_gate'/'w_up']: (D,F), w['w_down']: (F,D); ``group``: the
    model group where they hold this rank's d_ff columns and rows."""
    if group is not None:
        x = coll.sum_cotangents(x, group)
    g = torch.einsum("bsd,df->bsf", x, w["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, w["w_up"])
    out = torch.einsum("bsf,fd->bsd", silu(g) * u, w["w_down"])
    return out if group is None else coll.psum_replicated(out, group)
