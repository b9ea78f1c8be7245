"""Mamba-2 SSD (state-space duality) block: the chunked scan for prefill
and full forward, the O(1)-state recurrent step for decode -- the port of
``repro.models.ssm``.

Math (per head h, state dim N, head dim P):
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * B_t x_t^T        (S: P x N)
    y_t = C_t . S_t + D_skip * x_t

Kernel dispatch (``kernels``, as in ``layers``): under ``"auto"`` a CUDA
tensor's prefill scan goes to the SSD chunk scan kernel, which also gives
the final state; a CPU tensor runs ``ssd_chunked`` with the JAX package's
chunk rule.  ``"kernel"`` always goes through the kernel's wrapper,
``"ref"`` always runs ``ssd_chunked``.  The wrapper is differentiable (its
``autograd.Function`` recomputes ``ssd_chunked`` in the backward pass),
so training takes the same routes.

Tensor parallelism (``group``: the mesh's model group, given where the
block's leaves are split): each rank holds its d_inner columns of ``wz``,
``wx``, ``conv_x``, ``norm`` and rows of ``out_proj``, and its heads of
``wdt``, ``A_log``, ``D_skip`` and ``dt_bias``; ``wB``, ``wC``, ``conv_B``
and ``conv_C`` stay whole (the groups are shared by the heads).  The
input enters through ``sum_cotangents``, the gated norm's sum of squares
is summed over the group (an RMS over the whole d_inner), and the
``out_proj`` product through ``psum_replicated``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan.kernel import ssd_chunk_scan
from repro_torch.models import collectives as coll
from repro_torch.models.layers import rms_norm, silu, use_kernel


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) computed as JAX's ``softplus`` does, without a
    threshold (``torch.nn.functional.softplus`` returns x above 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} x[..., k]
    (lower-triangular; -inf above the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (arXiv:2405.21060 section 6).

    x: (b, s, h, p); dt: (b, s, h) (already softplus'd, > 0);
    A: (h,) (negative); B, C: (b, s, g, n) with h % g == 0.
    Returns y: (b, s, h, p) and the final state (b, h, p, n), float32
    (float64 for float64 inputs, for an oracle).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    rep = h // g
    work = torch.float64 if x.dtype == torch.float64 else torch.float32

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bh = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n), rep, dim=3)
    Ch = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n), rep, dim=3)

    dtA = (dtc * A[None, None, None, :]).to(work)         # (b,c,l,h) <= 0
    xdt = (xc * dtc[..., None].to(xc.dtype)).to(work)

    # intra-chunk (diagonal) term
    Lmat = torch.exp(segsum(dtA.permute(0, 1, 3, 2)))     # (b,c,h,l,l)
    scores = torch.einsum("bclhn,bcmhn->bchlm", Ch.to(work), Bh.to(work))
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", scores * Lmat, xdt)

    # per-chunk final states
    cum = torch.cumsum(dtA, dim=2)                         # (b,c,l,h)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (b,c,l,h)
    states = torch.einsum("bclhn,bclhp->bchpn", Bh.to(work),
                          decay_to_end[..., None] * xdt)   # (b,c,h,p,n)

    # inter-chunk recurrence (a loop over chunks)
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (b,c,h)
    carry = (torch.zeros((b, h, p, n), dtype=work, device=x.device)
             if init_state is None else init_state.to(work))
    prev = []
    for c in range(nc):
        prev.append(carry)               # the state *entering* chunk c
        carry = states[:, c] + chunk_decay[:, c, :, None, None] * carry
    prev_states = torch.stack(prev, dim=1)                 # (b,c,h,p,n)

    # inter-chunk (off-diagonal) output term
    decay_from_start = torch.exp(cum)                      # (b,c,l,h)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch.to(work), prev_states) \
        * decay_from_start[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
    return y, carry


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent step. state: (b,h,p,n); x: (b,h,p); dt: (b,h);
    B, C: (b,g,n). Returns (y (b,h,p), new_state)."""
    g = B.shape[1]
    rep = state.shape[1] // g
    Bh = torch.repeat_interleave(B, rep, dim=1)  # (b,h,n)
    Ch = torch.repeat_interleave(C, rep, dim=1)
    dtA = (dt * A[None, :]).float()
    new = (torch.exp(dtA)[:, :, None, None] * state
           + dt.float()[:, :, None, None]
           * x.float()[:, :, :, None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new, Ch.float())
    return y.to(x.dtype), new


# ---------------------------------------------------------------------------
# Full Mamba-2 block (projections + causal depthwise conv + SSD + gate)
# ---------------------------------------------------------------------------

def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           state: Optional[torch.Tensor] = None):
    """x: (b, s, c); w: (width, c). Returns (y, new_state (b, width-1, c))."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(width):  # width is 4: unrolled taps
        y = y + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y, new_state


def _split_rms_norm(x: torch.Tensor, gamma: torch.Tensor, group,
                    eps: float = 1e-5) -> torch.Tensor:
    """``rms_norm`` over the whole last axis of which each rank of
    ``group`` holds its columns: the sum of squares summed over the group
    (both ways: every rank's columns read the mean)."""
    dt = x.dtype
    x = x.float()
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    sq = coll.sum_cotangents(coll.psum_replicated(sq, group), group)
    var = sq / (x.shape[-1] * coll.group_size(group))
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def mamba_block(x: torch.Tensor, w: dict, cfg: SSMConfig, d_model: int,
                conv_state=None, ssm_state=None, decode: bool = False,
                kernels: str = "auto", group=None):
    """Mamba-2 mixer. x: (b, s, d_model). Weights:
      wz/wx (D, d_inner), wB/wC (D, g*n), wdt (D, h),
      conv_x (width, d_inner), conv_B/conv_C (width, g*n),
      A_log (h,), D_skip (h,), dt_bias (h,), norm (d_inner,),
      out_proj (d_inner, D)
    (d_inner and h this rank's under ``group``; the states its too).
    Returns (y, (conv_states, ssm_state)).
    """
    if group is not None:
        if w["wB"].shape[1] != cfg.d_state:
            raise NotImplementedError("a split SSM with several B/C groups")
        x = coll.sum_cotangents(x, group)
    b, s, _ = x.shape
    d_inner = w["wx"].shape[1]
    h = w["A_log"].shape[0]
    p = d_inner // h
    g = w["wB"].shape[1] // cfg.d_state
    n = cfg.d_state

    z = torch.einsum("bsd,de->bse", x, w["wz"])
    xs = torch.einsum("bsd,de->bse", x, w["wx"])
    Bv = torch.einsum("bsd,de->bse", x, w["wB"])
    Cv = torch.einsum("bsd,de->bse", x, w["wC"])
    dt = torch.einsum("bsd,dh->bsh", x, w["wdt"])

    cs = conv_state if conv_state is not None else (None, None, None)
    xs, cx = _causal_depthwise_conv(xs, w["conv_x"], cs[0])
    Bv, cb = _causal_depthwise_conv(Bv, w["conv_B"], cs[1])
    Cv, cc = _causal_depthwise_conv(Cv, w["conv_C"], cs[2])
    xs, Bv, Cv = silu(xs), silu(Bv), silu(Cv)

    dt = softplus(dt.float() + w["dt_bias"].float()[None, None])
    A = -torch.exp(w["A_log"].float())

    xh = xs.reshape(b, s, h, p)
    Bh = Bv.reshape(b, s, g, n)
    Ch = Cv.reshape(b, s, g, n)

    if decode:
        y1, new_state = ssd_decode_step(ssm_state, xh[:, 0], dt[:, 0], A,
                                        Bh[:, 0], Ch[:, 0])
        y = y1[:, None]
    elif use_kernel(kernels, x):
        # the kernel takes a ragged last chunk, so it keeps cfg.chunk where
        # the plain path below falls back to one chunk of length s
        y, new_state = ssd_chunk_scan(
            xh.contiguous(), dt.contiguous(), A, Bh.contiguous(),
            Ch.contiguous(), chunk=cfg.chunk, init_state=ssm_state)
    else:
        chunk = cfg.chunk if s % cfg.chunk == 0 else s
        y, new_state = ssd_chunked(xh, dt, A, Bh, Ch, chunk,
                                   init_state=ssm_state)
    y = y + xh * w["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    if group is None:
        y = rms_norm(y * silu(z), w["norm"])
    else:
        y = _split_rms_norm(y * silu(z), w["norm"], group)
    out = torch.einsum("bse,ed->bsd", y, w["out_proj"])
    if group is not None:
        out = coll.psum_replicated(out, group)
    return out, ((cx, cb, cc), new_state)
