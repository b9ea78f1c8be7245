"""The plain PyTorch version of the SSD chunk scan kernel: the port of the
recurrent oracle ``repro.kernels.ssd_scan.ref.ssd_scan_ref`` (the
definition, one step a position), which also returns the final state."""
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
