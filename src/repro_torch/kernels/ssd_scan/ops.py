"""Model layout adapter for the SSD chunk scan, the port of
``repro.kernels.ssd_scan.ops.ssd_scan``.  The port's kernel already works
in the model's layout and reads B and C from their group, so nothing is
transposed or broadcast here."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_chunk_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref_model


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             use_kernel: bool = True) -> torch.Tensor:
    """Model layout: x (b, s, h, p); dt (b, s, h); A (h,); B/C (b, s, g, n)
    with h % g == 0.  Returns y (b, s, h, p).  ``use_kernel=False`` takes
    the plain version."""
    if use_kernel:
        return ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)[0]
    return ssd_scan_ref_model(x, dt, A, B, C)[0]
