"""The plain PyTorch versions of the SSD chunk scan kernel.

``ssd_scan_ref`` is the port of the recurrent oracle
``repro.kernels.ssd_scan.ref.ssd_scan_ref`` (the definition, one step a
position), which also returns the final state; ``ssd_scan_ref_model`` is
the same in the model's layout and is what the wrapper runs on the CPU.

``ssd_chunk_state_ref``, ``ssd_state_passing_ref`` and
``ssd_chunk_scan_ref`` are the kernel's three passes in the same chunked
form (model layout, a ragged last chunk padded with dt = 0 and x = 0);
``ssd_scan_chunked_ref`` composes them, the same function as
``ssd_scan_ref_model``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, S, P); dt: (BH, S); A: (BH,); B, C: (BH, S, N); init_state
    (BH, P, N) or None (zero).  Returns y (BH, S, P) in x's dtype and the
    final state (BH, P, N), float32 (float64 for float64 inputs, for an
    oracle)."""
    BH, S, P = x.shape
    N = B.shape[-1]
    out_dtype = x.dtype
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    x, dt, A, B, C = (t.to(work) for t in (x, dt, A, B, C))
    state = (torch.zeros((BH, P, N), dtype=work, device=x.device)
             if init_state is None else init_state.to(work))
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)[:, None, None]
        state = (decay * state
                 + (dt[:, t, None] * x[:, t])[:, :, None] * B[:, t, None, :])
        ys.append(torch.einsum("bpn,bn->bp", state, C[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((BH, 0, P), dtype=work, device=x.device))
    return y.to(out_dtype), state


def ssd_scan_ref_model(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same in the model's layout: x (b, s, h, p); dt (b, s, h); A (h,);
    B, C (b, s, g, n) with h % g == 0; init_state (b, h, p, n) or None.
    Returns y (b, s, h, p) in x's dtype and the final state (b, h, p, n)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    xf = x.transpose(1, 2).reshape(b * h, s, p)
    dtf = dt.transpose(1, 2).reshape(b * h, s)
    Af = A[None, :].expand(b, h).reshape(b * h)
    Bf = torch.repeat_interleave(B, rep, dim=2).transpose(1, 2).reshape(
        b * h, s, n)
    Cf = torch.repeat_interleave(C, rep, dim=2).transpose(1, 2).reshape(
        b * h, s, n)
    s0 = None if init_state is None else init_state.reshape(b * h, p, n)
    y, state = ssd_scan_ref(xf, dtf, Af, Bf, Cf, s0)
    return (y.reshape(b, h, s, p).transpose(1, 2),
            state.reshape(b, h, p, n))


def _work(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(b, s, ...) -> (b, n_chunks, chunk, ...), zero past s."""
    b, s = t.shape[:2]
    nc = -(-s // chunk)
    pad = t.new_zeros((b, nc * chunk - s) + tuple(t.shape[2:]))
    return torch.cat([t, pad], dim=1).reshape((b, nc, chunk)
                                              + tuple(t.shape[2:]))


def _chunk_cum(dt: torch.Tensor, A: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt in chunks (b, nc, Q, h) and cum, its in-chunk prefix sum of
    dt A."""
    dtc = _chunks(dt.to(_work(dt)), chunk)
    return dtc, torch.cumsum(dtc * A.to(dtc.dtype), dim=2)


def _groups(B: torch.Tensor, h: int, chunk: int) -> torch.Tensor:
    """B or C (b, s, g, n) -> (b, nc, Q, h, n), head hh reading group
    hh / (h / g)."""
    return _chunks(torch.repeat_interleave(B, h // B.shape[2], dim=2), chunk)


def ssd_chunk_state_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, *, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1.  Each chunk's own contribution to the state,
    dS_c = sum_j exp(cum_end - cum_j) dt_j x_j B_j^T, (b, h, nc, p, n), and
    its decay exp(cum_end), (b, h, nc)."""
    work = _work(x)
    h = x.shape[2]
    dtc, cum = _chunk_cum(dt, A, chunk)
    xd = _chunks(x.to(work), chunk) * dtc[..., None]          # (b,nc,Q,h,p)
    wend = torch.exp(cum[:, :, -1:] - cum)                    # (b,nc,Q,h)
    states = torch.einsum("bcqhp,bcqhn->bhcpn", xd * wend[..., None],
                          _groups(B.to(work), h, chunk))
    return states, torch.exp(cum[:, :, -1]).transpose(1, 2)


def ssd_state_passing_ref(chunk_states: torch.Tensor,
                          chunk_decay: torch.Tensor,
                          init_state: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2.  S_c = decay_c S_{c-1} + dS_c from init_state (or zero).
    Returns the state entering each chunk (b, h, nc, p, n) and the final
    state (b, h, p, n)."""
    b, h, nc, p, n = chunk_states.shape
    s = (chunk_states.new_zeros((b, h, p, n)) if init_state is None
         else init_state.to(chunk_states.dtype))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = chunk_decay[:, :, c, None, None] * s + chunk_states[:, :, c]
    states_in = (torch.stack(entering, dim=2) if entering
                 else chunk_states.new_zeros((b, h, 0, p, n)))
    return states_in, s


def ssd_chunk_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       states_in: torch.Tensor, *, chunk: int
                       ) -> torch.Tensor:
    """Pass 3.  y = (C B^T * L)(x dt) + exp(cum) C S_{c-1}^T in each chunk,
    from the state entering it; returns y (b, s, h, p) in x's dtype."""
    work = _work(x)
    b, s, h, p = x.shape
    dtc, cum = _chunk_cum(dt, A, chunk)
    Bc, Cc = (_groups(t.to(work), h, chunk) for t in (B, C))
    xd = _chunks(x.to(work), chunk) * dtc[..., None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (b,nc,i,j,h)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    L = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xd)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcihn,bhcpn->bcihp", Cc, states_in.to(work))
    return y.reshape(b, -1, h, p)[:, :s].to(x.dtype)


def ssd_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor,
                         init_state: Optional[torch.Tensor] = None, *,
                         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three passes composed, in the model's layout: y (b, s, h, p) and
    the final state (b, h, p, n), as ``ssd_scan_ref_model``."""
    states, decay = ssd_chunk_state_ref(x, dt, A, B, chunk=chunk)
    states_in, final = ssd_state_passing_ref(states, decay, init_state)
    return (ssd_chunk_scan_ref(x, dt, A, B, C, states_in, chunk=chunk),
            final)
