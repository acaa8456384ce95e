"""The process-group layer of the distributed layouts.

The counterpart of what ``repro/compat.py`` and the mesh construction of
``repro/core/ibp/api.py`` do in the reference: processes joined by
``torch.distributed``, one a device of the reference's mesh.

* ``init_group`` joins this process to the group, from ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
  and ``MASTER_PORT``) or from an explicit rank, world size and
  ``init_method``; ``world`` says which rank and device this process is.
* The rank's device is ``cuda:<local_rank>`` unless the caller names
  one. With fewer cards than ranks and no device named, it raises: no
  rank quietly shares a card or moves to the CPU.
* The backend follows one rule, logged once: ``nccl`` when each rank
  has a card of its own (the default device, or any card in a world of
  one), ``gloo`` when the caller names one card for several ranks or
  runs on the CPU. A failure never switches the backend.
* The group has a timeout (``TIMEOUT_S``): a hung collective raises.
* ``make_mesh(shape, axis_names)`` lays the world's ranks out as the
  reference's device mesh: rank r sits at ``numpy.unravel_index(r,
  shape)`` (row-major), and holds one ``Group`` an axis, the ranks that
  differ from it along that axis only (``Mesh.group``; its coordinate
  there is ``Mesh.axis_index``). Every rank makes every group, in one
  order, as ``dist.new_group`` requires; a group of the whole world is
  the default group.
* ``all_reduce_sum`` and ``all_gather_rows`` run over a ``Group``
  (``group=``; default the world). They carry every collective of the
  sampler, and count their calls and host seconds in all and by group
  name (``collective_counts``, ``collective_seconds``), as the kernel
  wrappers count their launches. ``barrier`` waits for the world.
* ``spawn`` runs a function on every rank of a new group of processes,
  for tests and for ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as _device

TIMEOUT_S = 120.0
log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the group."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks along one axis of a mesh: ``name`` (the axis; the
    counters' key), ``ranks`` (world ranks in axis order) and the process
    group (None: the default group, when the axis spans the world)."""

    name: str
    ranks: tuple[int, ...]
    pg: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a mesh of the world's ranks: the mesh's
    ``shape`` and ``axis_names``, this rank's ``coords``, and its
    ``Group`` along each axis."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    coords: tuple[int, ...]
    groups: tuple[Group, ...]

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {name!r}")
        return self.axis_names.index(name)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        return self.coords[self._axis(name)]

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def group(self, name: str) -> Group:
        """This rank's group along axis ``name``."""
        return self.groups[self._axis(name)]


_WORLD: World | None = None
_MESHES: dict[tuple, Mesh] = {}
OPS = ("all_reduce_sum", "all_gather_rows")
_WORLD_NAME = "world"  # the counters' name of the default group
# calls and host seconds of each collective, in all (key None) and by
# group name
_CALLS: dict[str | None, dict[str, int]] = {}
_SECONDS: dict[str | None, dict[str, float]] = {}


def world() -> World | None:
    """This process's ``World``, or None when ``init_group`` has not run."""
    return _WORLD


def _rank_device(device: str | torch.device | None, local_rank: int,
                 size: int) -> torch.device:
    if device is None or str(device) == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank >= n:
            raise RuntimeError(
                f"rank with local_rank={local_rank} of {size} has no card of "
                f"its own ({n} visible); name the device (device='cuda:0') "
                f"to put several ranks on one card, or device='cpu'")
        device = f"cuda:{local_rank}"
    return _device.resolve(device)


def _backend_for(device: torch.device, named: bool, size: int) -> str:
    """The rule: nccl when each rank has a card of its own, gloo when
    several ranks share a named card or the ranks run on the CPU."""
    if device.type == "cuda" and (not named or size == 1):
        return "nccl"
    return "gloo"


def init_group(rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None,
               device: str | torch.device | None = None) -> World:
    """Join this process to the group and return its ``World``.

    With no rank given, reads torchrun's environment (``init_method``
    ``env://``). ``device`` None or ``"cuda"`` is ``cuda:<local_rank>``;
    a named device (``"cuda:0"``, ``"cpu"``) is taken as it is.
    """
    global _WORLD
    if _WORLD is not None or dist.is_initialized():
        raise RuntimeError("init_group: this process is already in a group")
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    else:
        if world_size is None or init_method is None:
            raise ValueError("init_group: an explicit rank needs world_size "
                             "and init_method")
        local_rank = rank
    named = device is not None and str(device) != "cuda"
    dev = _rank_device(device, local_rank, world_size)
    backend = _backend_for(dev, named, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # the context goes on the rank's card
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _WORLD = World(rank=rank, size=world_size, local_rank=local_rank,
                   device=dev, backend=backend)
    if rank == 0:
        log.info("process group: %d ranks over %s on %s%s", world_size,
                 backend, dev, " (named)" if named else "")
    return _WORLD


def destroy_group() -> None:
    """Leave the group (each rank, at its end)."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None
    _MESHES.clear()


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    """The world's ranks as a mesh of ``shape`` (its size the world's),
    rank r at ``unravel_index(r, shape)``, the reference mesh's device
    order. Every rank calls it with the same arguments (each rank makes
    every group, in one order); a mesh already made is returned again."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if (shape, axis_names) in _MESHES:
        return _MESHES[(shape, axis_names)]
    if _WORLD is None:
        raise RuntimeError("make_mesh: this process is in no group")
    if len(shape) != len(axis_names) or math.prod(shape) != _WORLD.size:
        raise ValueError(f"make_mesh: shape {shape} over axes {axis_names} "
                         f"does not lay out a world of {_WORLD.size} ranks")
    coords = tuple(int(c) for c in np.unravel_index(_WORLD.rank, shape))
    grid = np.arange(_WORLD.size).reshape(shape)
    groups = []
    for a, name in enumerate(axis_names):
        mine = None
        # every line of the grid along axis a, in row-major order of the
        # other coordinates
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines:
            ranks = tuple(int(r) for r in line)
            if len(ranks) == _WORLD.size:
                pg = None
            else:
                pg = dist.new_group(list(ranks))
            if _WORLD.rank in ranks:
                mine = Group(name, ranks, pg)
        groups.append(mine)
    mesh = Mesh(shape, axis_names, coords, tuple(groups))
    _MESHES[(shape, axis_names)] = mesh
    return mesh


def _count(name: str, group: Group | None, t0: float) -> None:
    dt = time.perf_counter() - t0
    for key in (None, _WORLD_NAME if group is None else group.name):
        calls = _CALLS.setdefault(key, dict.fromkeys(OPS, 0))
        secs = _SECONDS.setdefault(key, dict.fromkeys(OPS, 0.0))
        calls[name] += 1
        secs[name] += dt


def collective_counts(group: str | None = None) -> dict[str, int]:
    """Calls of each collective since the last reset: in all, or over the
    groups named ``group`` (an axis name, or ``"world"`` for the default
    group)."""
    return dict(_CALLS.get(group, dict.fromkeys(OPS, 0)))


def collective_seconds(group: str | None = None) -> dict[str, float]:
    """Host seconds spent in each collective since the last reset (in
    all, or over the groups named ``group``)."""
    return dict(_SECONDS.get(group, dict.fromkeys(OPS, 0.0)))


def reset_collective_counts() -> None:
    _CALLS.clear()
    _SECONDS.clear()


def _pg(group: Group | None):
    return None if group is None else group.pg


def all_reduce_sum(*tensors: torch.Tensor, group: Group | None = None):
    """The sum over the ranks of ``group`` (default: the world) of each
    tensor, in ONE collective: the tensors (one dtype) are flattened into
    one payload in argument order, reduced and split back. Returns one
    tensor, or a tuple for several."""
    t0 = time.perf_counter()
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_pg(group))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    _count("all_reduce_sum", group, t0)
    return out[0] if len(out) == 1 else tuple(out)


def all_gather_rows(t: torch.Tensor, group: Group | None = None
                    ) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (default: the world) concatenated
    along dim 0 in the group's rank order, on ``t``'s device.

    gloo has no all_gather of CUDA tensors, so under gloo a CUDA tensor is
    gathered through its host copy; nccl gathers on the device, a host
    tensor through its copy on the rank's card.
    """
    t0 = time.perf_counter()
    w = _WORLD
    src = t.contiguous()
    if w is not None and w.backend == "gloo" and src.is_cuda:
        src = src.cpu()
    elif w is not None and w.backend == "nccl" and not src.is_cuda:
        src = src.to(w.device)
    n = dist.get_world_size() if group is None else group.size
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=_pg(group))
    out = torch.cat(parts).to(t.device)
    _count("all_gather_rows", group, t0)
    return out


def barrier() -> None:
    """Wait for every rank of the world, as after rank 0 writes a file the
    others read."""
    w = _WORLD
    if w is not None and w.backend == "nccl":
        dist.barrier(device_ids=[w.device.index])
    else:
        dist.barrier()


# --------------------------------------------------------------------------
# spawn: a function on every rank of a new group
# --------------------------------------------------------------------------


def _rank_main(fn, rank: int, size: int, init_method: str, device,
               args: tuple, out) -> None:
    # P ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    try:
        init_group(rank, size, init_method, device=device)
        result = fn(*args)
        out.put((rank, True, result, ""))
    except BaseException as e:  # reported to the parent, which re-raises
        tb = traceback.format_exc()
        try:
            out.put((rank, False, e, tb))
        except Exception:  # the exception does not pickle
            out.put((rank, False, RuntimeError(repr(e)), tb))
        if not isinstance(e, Exception):
            raise
    finally:
        destroy_group()


class RankFailed(Exception):
    """Carries a failed rank's traceback as the cause of its exception."""


def spawn(fn: Callable, size: int, *args: Any,
          device: str | torch.device | None = None,
          timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``size`` new processes, ranks 0..size-1 of a
    group joined through a file store (start method ``spawn``), each on
    ``device`` (see ``init_group``). Returns the ranks' results in rank
    order. A rank's exception is raised here (its traceback as the
    cause) as soon as it arrives, and the other ranks are stopped; so is
    a run past ``timeout_s``. ``fn`` and its arguments and result must
    pickle: ``fn`` a module-level function.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, size, f"file://{os.path.join(d, 'store')}",
            None if device is None else str(device), args, out))
            for r in range(size)]
        for p in procs:
            p.start()
        results: list = [None] * size
        deadline = time.monotonic() + timeout_s
        try:
            for _ in range(size):
                left = deadline - time.monotonic()
                try:
                    rank, ok, value, tb = out.get(timeout=max(left, 0.0))
                except queue.Empty:
                    raise TimeoutError(
                        f"spawn: {size} ranks did not finish in "
                        f"{timeout_s} s") from None
                if not ok:
                    raise value from RankFailed(f"rank {rank}:\n{tb}")
                results[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"spawn: ranks exited with codes {bad}")
    return results
