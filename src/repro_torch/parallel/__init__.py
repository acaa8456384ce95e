"""Processes of the distributed layouts: the group, its mesh, its
collectives and a spawn helper (``group``)."""
from .group import (
    Group,
    Mesh,
    World,
    all_gather_rows,
    all_reduce_sum,
    barrier,
    collective_counts,
    collective_seconds,
    destroy_group,
    init_group,
    make_mesh,
    reset_collective_counts,
    spawn,
    world,
)

__all__ = [
    "Group",
    "Mesh",
    "World",
    "all_gather_rows",
    "all_reduce_sum",
    "barrier",
    "collective_counts",
    "collective_seconds",
    "destroy_group",
    "init_group",
    "make_mesh",
    "reset_collective_counts",
    "spawn",
    "world",
]
