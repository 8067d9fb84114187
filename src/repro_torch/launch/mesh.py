"""Meshes of ranks: the port's counterpart of ``repro/launch/mesh.py``.

The paper's placement (§4.2) maps onto the axes as:
  pod   -> DC            (pipeline stages cross it; thin DCN = WAN)
  data  -> DP inside a DC (all-reduce rings never leave a pod)
  model -> TP/EP on fast interconnect

A ``Mesh`` lays the ranks of ``torch.distributed``'s world out row-major over
its axes, as ``jax.make_mesh`` lays devices out: on a (pod, data, model) mesh
rank = (pod * DP + data) * TP + model.  It holds one process group for each
axis slice through this rank (an axis of size 1 needs none).  A world of one
process with no process group is a mesh of ones, whose collectives are
identities.

Functions, not module-level constants: importing this module makes no group.
"""
from __future__ import annotations

import datetime
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

# how long a collective waits on another rank before it raises: the axis
# groups' timeout, and the one each caller gives ``init_process_group`` (its
# default group carries the pipeline's sends and receives)
TIMEOUT = datetime.timedelta(seconds=120)
PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


class Mesh:
    """Named axes over the ranks of a world.  ``shape`` maps each axis name
    to its size in order, as a JAX mesh's; ``coords`` gives this rank's index
    on each axis."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords: Dict[str, int] = dict(zip(self.axis_names, _unravel(rank, tuple(self.shape.values()))))
        self._groups = groups or {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def rank_at(self, **coords: int) -> int:
        """The rank at this rank's coordinates with ``coords`` replaced."""
        at = {**self.coords, **coords}
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + at[name]
        return r

    def group(self, axis: str):
        """The process group of ``axis`` through this rank; None where the
        axis has size 1 (nothing to talk to)."""
        if self.shape[axis] == 1:
            return None
        if axis not in self._groups:
            raise RuntimeError(f"{self}: no process group for axis {axis!r}; build the mesh with make_mesh")
        return self._groups[axis]


def _unravel(rank: int, shape: Tuple[int, ...]) -> List[int]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return out[::-1]


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The counterpart of ``jax.make_mesh``: ``shape`` over the world's ranks,
    which must number exactly ``prod(shape)``.  Every rank creates every
    axis group in the same order (``dist.new_group`` is collective) and keeps
    the ones through itself, each with ``TIMEOUT``."""
    rank, n = world()
    mesh = Mesh(shape, axis_names, 0)
    if mesh.size != n:
        raise ValueError(f"a mesh {mesh.shape} needs {mesh.size} ranks; the world has {n}")
    groups = {}
    for axis in mesh.axis_names:
        if mesh.shape[axis] == 1:
            continue
        others = [a for a in mesh.axis_names if a != axis]
        for fixed in itertools.product(*(range(mesh.shape[a]) for a in others)):
            members = [mesh.rank_at(**dict(zip(others, fixed)), **{axis: i}) for i in range(mesh.shape[axis])]
            pg = dist.new_group(members, timeout=TIMEOUT)
            if rank in members:
                groups[axis] = pg
    return Mesh(shape, axis_names, rank, groups)


def production_mesh_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    return PRODUCTION_SHAPE[multi_pod]


def host_mesh_shape(n: int, multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The reference's ``make_host_mesh`` arithmetic over ``n`` ranks."""
    if multi_pod:
        if n < 8 or n % 2:
            raise ValueError(f"a multi-pod host mesh needs an even number of at least 8 ranks, not {n}")
        dp = 2
        return (2, dp, (n // 2) // dp), ("pod", "data", "model")
    if n == 1:
        return (1, 1), ("data", "model")
    dp = 2 if n % 2 == 0 else 1
    return (dp, n // dp), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data, model):
    raises unless the world has exactly its 256 or 512 ranks (never shrinks)."""
    return make_mesh(*production_mesh_shape(multi_pod))


def make_host_mesh(*, multi_pod: bool = False) -> Mesh:
    """A small mesh over whatever ranks the world has."""
    return make_mesh(*host_mesh_shape(world()[1], multi_pod))
