"""Meshes of ranks (port of ``repro/launch/mesh.py``).

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"); the
"pod" axis is the decentralized-gossip axis for the >256 GB architectures
(DESIGN.md Sec. 3).

A :class:`Mesh` lays the ranks of a ``torch.distributed`` group out over
named axes, rank r at the row-major coordinates of the shape, as
``jax.make_mesh`` lays out devices.  A live mesh knows this rank's
coordinates and holds one process group per axis: the ranks that share
every other coordinate.  A shape-only mesh (:func:`make_production_mesh`)
has neither; the sharding rules read only ``shape`` and ``axis_names``.
A dry mesh (:func:`dry_mesh`) has a rank's coordinates and, for groups,
:class:`DryGroup` stand-ins: the dry run (``launch.dryrun``) runs that
rank's step on it, its collectives and gossip counted and not sent
(``dist.tp.DryCollectives``, ``dist.gossip``'s dry wire).

Functions, not module-level constants: importing this module creates no
process group.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any

import torch.distributed as dist


@dataclass(frozen=True)
class DryGroup:
    """A process group's stand-in on a dry mesh: its size and this
    rank's place in it.  Nothing is sent over it; what uses it counts
    what a live group would carry."""
    size: int
    rank: int


@dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name to its size, in ``axis_names``
    order.  ``coords`` (this rank's coordinate per axis) and ``groups``
    (one process group per axis whose size exceeds 1) are None on a
    shape-only mesh.  ``dry``: the groups are :class:`DryGroup` stand-ins
    (:func:`dry_mesh`)."""
    shape: dict
    coords: dict | None = None
    groups: dict | None = field(default=None, repr=False)
    dry: bool = False

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def live(self) -> bool:
        return self.coords is not None

    def group(self, axis: str) -> Any:
        """The process group of ``axis`` this rank is in (None for an axis
        of size 1: it needs no collective)."""
        if not self.live:
            raise ValueError("a shape-only mesh has no process groups")
        if self.groups is None:
            raise ValueError("this mesh was given coordinates and no "
                             "process groups")
        return self.groups.get(axis)


def rank_coords(mesh, rank: int) -> dict:
    """Rank ``rank``'s coordinate on each axis of ``mesh`` (anything with
    a ``shape`` dict): the row-major position of ``rank`` in the shape."""
    coords = {}
    for axis in reversed(tuple(mesh.shape)):
        rank, coords[axis] = divmod(rank, mesh.shape[axis])
    return {a: coords[a] for a in mesh.shape}


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """A live mesh over the default ``torch.distributed`` group (one rank,
    and no group, when it is not initialised), whose size must equal the
    product of ``shape``.  Every rank must call this in the same order:
    each creates every axis's subgroups, in the same order, and keeps
    those it belongs to."""
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} do not "
                         f"match")
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the group has {world}")
    mesh = Mesh(dict(zip(axis_names, shape)))
    ranks = [tuple(rank_coords(mesh, r).values()) for r in range(world)]
    groups = {}
    for i, axis in enumerate(axis_names):
        if shape[i] == 1:
            continue
        # one group per setting of the other coordinates; its ranks rise
        # with the coordinate along the axis, so a group rank is that
        # coordinate
        for other in itertools.product(*(range(s) for j, s in
                                         enumerate(shape) if j != i)):
            members = [r for r, c in enumerate(ranks)
                       if c[:i] + c[i + 1:] == other]
            g = dist.new_group(members)
            if me in members:
                groups[axis] = g
    return Mesh(mesh.shape, rank_coords(mesh, me), groups)


def make_host_mesh(*, model: int = 1) -> Mesh:
    """The group's ranks as a live ``(world // model, model)`` mesh, axes
    ("data", "model")."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the {world} "
                         f"ranks")
    return make_mesh((world // model, model), ("data", "model"))


def dry_mesh(mesh: Mesh, rank: int = 0) -> Mesh:
    """``mesh``'s shape with rank ``rank``'s coordinates and a
    :class:`DryGroup` per axis whose size exceeds 1: what the dry run
    steps one rank on."""
    coords = rank_coords(mesh, rank)
    return Mesh(dict(mesh.shape), coords,
                {a: DryGroup(n, coords[a]) for a, n in mesh.shape.items()
                 if n > 1}, dry=True)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape, (16, 16) or (2, 16, 16), without
    ranks: what the sharding rules and a dry run read."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


# NVIDIA H100 SXM constants for the roofline analysis (per card, NVIDIA's
# data sheet; dense rates, at the 700 W power limit).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
HBM_BW = 3.35e12                # B/s
NVLINK_BW_PER_LINK = 25e9       # B/s per NVLink 4 link per direction
HBM_BYTES = 80e9                # the H100 SXM's 80 GB of HBM3
