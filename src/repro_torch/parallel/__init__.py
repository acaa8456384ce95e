"""Processes of the data-parallel layout: the group, its collectives and
a spawn helper (``group``)."""
from .group import (
    World,
    all_gather_rows,
    all_reduce_sum,
    barrier,
    collective_counts,
    collective_seconds,
    destroy_group,
    init_group,
    reset_collective_counts,
    spawn,
    world,
)

__all__ = [
    "World",
    "all_gather_rows",
    "all_reduce_sum",
    "barrier",
    "collective_counts",
    "collective_seconds",
    "destroy_group",
    "init_group",
    "reset_collective_counts",
    "spawn",
    "world",
]
