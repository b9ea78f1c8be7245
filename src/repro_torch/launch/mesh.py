"""Meshes over ``torch.distributed`` (the counterpart of
``repro.launch.mesh``): the 2-D (host, device) worker mesh of the sharded
graph executor (``graph_mesh``) and the training mesh of the LM
(``make_mesh``, ``make_production_mesh``), both read row-major over the
default process group.

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

import math
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


DP_AXES = ("pod", "data")
MP_AXIS = "model"


def coords_of(shape: dict, rank: int) -> dict:
    """The coordinates (axis -> index) of flat rank ``rank`` on a mesh of
    ``shape`` (axis -> size, in axis order), row-major."""
    coords, rest = {}, rank
    for a in reversed(list(shape)):
        coords[a] = rest % shape[a]
        rest //= shape[a]
    return {a: coords[a] for a in shape}


class Mesh:
    """The reference's ``("data", "model")`` or ``("pod", "data",
    "model")`` training mesh on this rank: ``shape`` (axis -> size, in
    axis order) and ``axis_names`` as the reference's mesh has them, this
    rank's coordinates (``coords``, row-major: the flat rank), and its two
    process groups: the data group (the ranks with this rank's model
    index, ``data_size`` of them: the data axes flattened) and the model
    group (the ranks of this rank's data slice, ``model_size`` of them).
    ``make_mesh`` builds the groups; a mesh made directly has none, and
    only answers the sharding rules (``launch.shardings``) and slices
    trees (``shard_tree``)."""

    def __init__(self, shape, axes, rank: int = 0):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "pair up")
        unknown = [a for a in axes if a not in DP_AXES + (MP_AXIS,)]
        if unknown:
            raise ValueError(f"mesh axes {unknown}: the training mesh's "
                             f"axes are {DP_AXES + (MP_AXIS,)}")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.size = math.prod(shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not on the mesh {self.shape}")
        self.rank = rank
        self.coords = coords_of(self.shape, rank)
        self.model_size = self.shape.get(MP_AXIS, 1)
        self.data_size = self.size // self.model_size
        self.model_rank = self.coords.get(MP_AXIS, 0)
        self.data_rank = rank // self.model_size
        self.data_group = self.model_group = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(shape, axes) -> Mesh:
    """This rank's mesh of ``shape`` over the default process group,
    whose world size must be the mesh's size; rank r is the mesh's device
    r, row-major.  The data and model groups are the column and host
    groups of ``graph_mesh(data size, model size)`` (created by every rank
    in the same order, cached, dropped by ``destroy``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"make_mesh({tuple(shape)}) needs the default "
                           "process group: call "
                           "torch.distributed.init_process_group first")
    mesh = Mesh(shape, axes, dist.get_rank())
    model_group, data_group = graph_mesh(mesh.data_size, mesh.model_size)
    mesh.data_group, mesh.model_group = data_group, model_group
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DP_AXES)


def mp_axis(mesh) -> str:
    return MP_AXIS


def destroy() -> None:
    """Destroy the default process group and every subgroup, dropping the
    cached mesh subgroups first: a gloo subgroup that the cache keeps
    alive after its group is destroyed is torn down only at interpreter
    exit, where it can abort the process."""
    _GROUPS.clear()
    dist.destroy_process_group()
