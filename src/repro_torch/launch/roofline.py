"""Three-term roofline model for the NVIDIA H100, fed by the dry-run
artifacts (the counterpart of ``repro.launch.roofline``, with the card's
figures in place of the reference's):

    compute    = FLOPs_per_chip / peak FLOP/s of the cell's dtype
    memory     = HBM_bytes_per_chip / HBM rate
    collective = collective_bytes_per_chip / link rate

The figures are the H100 SXM5 80GB's published ones, not measurements:

* ``PEAK_FLOPS``: 989.4e12 dense bfloat16 FLOP/s on the tensor cores;
  ``FP32_FLOPS``: 67e12 float32 FLOP/s outside them (a float32 cell);
* ``HBM_BW``: 3.35e12 B/s of HBM3;
* ``NVLINK_BW``: 450e9 B/s of NVLink a direction, for a group that lies
  within one 8-GPU node;
* ``NET_BW``: 50e9 B/s, one 400 Gb/s NDR port a GPU, for a group that
  spans nodes.  On the 16 x 16 production mesh both axes span nodes (a
  model group is 16 consecutive ranks, two nodes), so that is the rate
  the dry run uses.

The per-chip inputs are what ``launch.dryrun`` measured on rank 0's
program.  ``model_flops`` (6·N·D for train, 2·N_active a token otherwise)
gives the useful-compute ratio that catches remat and dispatch
overcompute.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

PEAK_FLOPS = 989.4e12    # dense bfloat16 FLOP/s, tensor cores (published)
FP32_FLOPS = 67e12       # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12         # bytes/s of HBM3
NVLINK_BW = 450e9        # bytes/s a direction, within one 8-GPU node
NET_BW = 50e9            # bytes/s, one 400 Gb/s NDR port a GPU
NODE_GPUS = 8


def peak_flops(dtype: torch.dtype = torch.bfloat16) -> float:
    """The card's peak FLOP/s for products in ``dtype``."""
    return FP32_FLOPS if dtype == torch.float32 else PEAK_FLOPS


def link_bw(ranks) -> float:
    """The rate of a group of flat ``ranks``: NVLink where they all lie in
    one node of ``NODE_GPUS``, else the network."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) == 1 else NET_BW


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Paper-standard useful FLOPs for the whole cell (all chips)."""
    pc = cfg.param_counts()
    n_active = pc["active"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


@dataclasses.dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_per_chip: float
    useful_ratio: float
    n_chips: int
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (higher = closer to
        the compute roofline with zero overhead)."""
        ideal = self.model_flops / (self.n_chips * self.peak_flops)
        return ideal / max(self.bound_s, 1e-30)


def analyze(cfg: ArchConfig, shape: ShapeConfig, n_chips: int,
            flops_per_chip: float, bytes_per_chip: float,
            coll_bytes_per_chip: float, dtype: torch.dtype = torch.bfloat16,
            coll_bw: float = NET_BW) -> Roofline:
    """The roofline of one cell; ``dtype`` picks the peak FLOP/s,
    ``coll_bw`` the link rate (``link_bw`` of the groups)."""
    mf = model_flops(cfg, shape)
    peak = peak_flops(dtype)
    return Roofline(
        compute_s=flops_per_chip / peak,
        memory_s=bytes_per_chip / HBM_BW,
        collective_s=coll_bytes_per_chip / coll_bw,
        model_flops=mf,
        hlo_flops_per_chip=flops_per_chip,
        useful_ratio=mf / max(flops_per_chip * n_chips, 1e-30),
        n_chips=n_chips,
        peak_flops=peak,
    )
