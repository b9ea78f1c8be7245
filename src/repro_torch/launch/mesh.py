"""The 2-D (host, device) worker mesh of the sharded graph executor over
``torch.distributed`` (the counterpart of ``repro.launch.mesh.graph_mesh``).

The mesh is the default process group of world size H*T read row-major:
flat rank d = h*T + t is device t of host h, the reference's device order,
so owner arithmetic and the 1-D tables stay valid.  The hierarchical
exchanges ride two families of process subgroups:

* the host group ``{h*T, ..., h*T + T - 1}`` (the reference's axis
  ``"w"``): the intra-host leg; a rank's index in it is t;
* the column group ``{t, T + t, 2T + t, ...}`` (axis ``"h"``): the
  inter-host leg; a rank's index in it is h.

Every rank creates every subgroup, in the same order, as
``torch.distributed`` requires.  The groups are made once per (H, T) and
default group and cached: a later run on the same mesh reuses them.
``destroy`` drops them with the default group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch.distributed as dist

_GROUPS: Dict[Tuple[int, int], tuple] = {}


def host_ranks(H: int, T: int) -> list:
    """The ranks of each host group, host by host."""
    return [[h * T + t for t in range(T)] for h in range(H)]


def column_ranks(H: int, T: int) -> list:
    """The ranks of each column group, column by column."""
    return [[h * T + t for h in range(H)] for t in range(T)]


def graph_mesh(hosts: int, per_host: int):
    """``(host_group, column_group)`` of this rank on the (hosts,
    per_host) mesh over the default process group, which must have world
    size hosts * per_host.  No fallback: a missing or mismatched group, or
    a subgroup that fails to form, raises."""
    H, T = int(hosts), int(per_host)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"graph_mesh({H}, {T}) needs the default process "
                           "group: call torch.distributed.init_process_group "
                           "first")
    if dist.get_world_size() != H * T:
        raise RuntimeError(f"graph_mesh({H}, {T}) needs world size {H * T}, "
                           f"the default group has {dist.get_world_size()}")
    world = dist.group.WORLD
    cached = _GROUPS.get((H, T))
    if cached is not None and cached[0] is world:
        return cached[1], cached[2]
    host_group, _ = dist.new_subgroups_by_enumeration(host_ranks(H, T))
    col_group, _ = dist.new_subgroups_by_enumeration(column_ranks(H, T))
    rank = dist.get_rank()
    for name, group, size, index in (("host", host_group, T, rank % T),
                                     ("column", col_group, H, rank // T)):
        if (group is None or dist.get_world_size(group) != size
                or dist.get_rank(group) != index):
            raise RuntimeError(f"the {name} subgroup of rank {rank} on the "
                               f"({H}, {T}) mesh did not form")
    _GROUPS[(H, T)] = (world, host_group, col_group)
    return host_group, col_group


def destroy() -> None:
    """Destroy the default process group and every subgroup, dropping the
    cached mesh subgroups first: a gloo subgroup that the cache keeps
    alive after its group is destroyed is torn down only at interpreter
    exit, where it can abort the process."""
    _GROUPS.clear()
    dist.destroy_process_group()
