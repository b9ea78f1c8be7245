"""Plain PyTorch version of the worker_count kernel.

``out[m]`` is the int64 sum of ``counts[i]`` over the ``i`` with
``worker[i] == m``, for ``m`` in ``[0, M)``: the reference's
``zeros(M).at[worker].add(counts)``.  A lane whose id lies outside
``[0, M)`` adds nothing.  Counts are bool flags or integers, summed in
int64 (exact, wrapping as any int64 sum).  CPU tensors always take this
path; the tests hold the kernel (``kernel.py``) to it on the card.  Both
take the same dtypes, so a caller the CPU tests run cannot hand the card
one that the kernel refuses.
"""
from __future__ import annotations

import torch

ID_DTYPES = (torch.int32, torch.int64)
COUNT_DTYPES = (torch.bool, torch.int32, torch.int64)


def check(worker: torch.Tensor, counts: torch.Tensor) -> None:
    """Raise on dtypes the kernel does not take, or shapes that differ."""
    if worker.dtype not in ID_DTYPES:
        raise TypeError(f"worker ids must be int32 or int64, got "
                        f"{worker.dtype}")
    if counts.dtype not in COUNT_DTYPES:
        raise TypeError(f"counts must be bool, int32 or int64, got "
                        f"{counts.dtype}")
    if worker.shape != counts.shape:
        raise ValueError(f"worker {tuple(worker.shape)} and counts "
                         f"{tuple(counts.shape)} differ in shape")


def worker_count_ref(worker: torch.Tensor, counts: torch.Tensor,
                     M: int) -> torch.Tensor:
    """(M,) int64 totals of ``counts`` by ``worker`` id."""
    check(worker, counts)
    worker = worker.reshape(-1)
    keep = (worker >= 0) & (worker < M)
    out = torch.zeros(M + 1, dtype=torch.int64, device=worker.device)
    out.index_add_(0, torch.where(keep, worker, M).long(),
                   counts.reshape(-1).long())
    return out[:M]
