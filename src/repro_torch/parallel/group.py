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
  there is ``Mesh.axis_index``), and one a run of two or more
  consecutive axes short of all of them (a mesh of three axes: ``"pod+data"``
  and ``"data+model"``), for the layouts that split a dim over several
  axes. Every rank makes every group, in one order, as
  ``dist.new_group`` requires; a group of the whole world is the default
  group.
* ``all_reduce_sum`` and ``all_gather_rows`` run over a ``Group``
  (``group=``; default the world). They carry every collective of the
  sampler. The LM on a mesh adds ``all_gather`` and ``reduce_scatter``
  along any dim and ``all_to_all`` (JAX's tiled ``all_to_all``); these
  three, and ``all_reduce_sum`` of a tensor that requires grad, are
  ``torch.autograd.Function``s: all-gather and reduce-scatter are each
  other's backward, an all-to-all's is the reverse all-to-all, an
  all-reduce's is the all-reduce of the gradients. Every collective
  counts its calls, bytes and host seconds in all and by group name
  (``collective_counts``, ``collective_bytes``, ``collective_seconds``),
  backward ones included, as the kernel wrappers count their launches.
  A call's bytes are those of its result, the reference dry run's
  convention: an all-gather's gathered tensor, an all-reduce's reduced
  payload, a reduce-scatter's shard, an all-to-all's result. Under gloo a
  CUDA tensor goes through its host copy in the LM's three collectives
  and in ``all_gather_rows`` (gloo has no all-gather of CUDA tensors),
  by rule, logged once. ``barrier`` waits for the world.
* ``Sharding`` says where each rank's slice of a tensor lies on a mesh;
  ``shard_tensor``, ``gather_tensor`` (``gather_tensors``: many, one
  all-gather an axis) and ``slice_tensor`` move a tensor between
  layouts; ``fit_spec`` is the divisibility fallback of every layout (an
  entry whose axes do not divide its dim becomes None). ``shard_model``
  keeps each rank's slice of every parameter of a model and
  ``unshard_model`` gathers them back.
* ``spawn`` runs a function on every rank of a new group of processes,
  for tests and for ``chip_smoke.py``.
* ``fake_world`` makes this one process rank r of a simulated world
  under PyTorch's ``"fake"`` backend: every collective returns at once
  and moves nothing (an all-reduce leaves its payload as it was; a
  gather's output is zeros). Meshes, groups and the counters work as in
  a real world, which is what the dry run (``launch/dryrun.py``) reads.
  Only the dry run asks for it; nothing falls back to or from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import math
import os
import queue
import tempfile
import time
import traceback
from collections.abc import Mapping
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
    ``shape`` and ``axis_names``, this rank's ``coords``, its ``Group``
    along each axis, and its ``Group`` along each run of consecutive
    axes short of the whole mesh (``spans``: (axes, group) pairs; none
    for a mesh of two axes or fewer)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    coords: tuple[int, ...]
    groups: tuple[Group, ...]
    spans: tuple = ()

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
OPS = ("all_reduce_sum", "all_gather_rows", "all_gather", "reduce_scatter",
       "all_to_all")
_WORLD_NAME = "world"  # the counters' name of the default group
FAKE = "fake"          # the simulated backend of ``fake_world``
# calls, bytes and host seconds of each collective, in all (key None) and
# by group name
_CALLS: dict[str | None, dict[str, int]] = {}
_BYTES: dict[str | None, dict[str, int]] = {}
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


@contextlib.contextmanager
def fake_world(rank: int, world_size: int, device="cuda"):
    """This process as rank ``rank`` of a simulated world of
    ``world_size`` ranks, joined to PyTorch's ``"fake"`` backend through
    a ``FakeStore``; the group is left on exit. ``device`` (default
    ``cuda``: the current card; ``device.resolve``'s rule, so no GPU
    raises) is the rank's device. Yields the ``World``.

    Every collective returns at once and moves nothing: an all-reduce
    leaves its payload as this rank's, and an all-gather, reduce-scatter
    or all-to-all returns zeros (its output buffer, zero-filled in this
    world only, so that a real tensor that feeds a step is defined). The
    counters count as in a real world."""
    global _WORLD
    if _WORLD is not None or dist.is_initialized():
        raise RuntimeError("fake_world: this process is already in a group")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dev = _device.resolve(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(FAKE, store=FakeStore(), rank=rank,
                            world_size=world_size)
    _WORLD = World(rank=rank, size=world_size, local_rank=rank, device=dev,
                   backend=FAKE)
    try:
        yield _WORLD
    finally:
        destroy_group()


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
    n = len(shape)
    runs = [(a,) for a in range(n)] + [
        tuple(range(a, a + k)) for k in range(2, n) for a in range(n - k + 1)]
    made = []
    for run in runs:
        name = "+".join(axis_names[a] for a in run)
        mine = None
        # every block of the grid along the run's axes, in row-major
        # order of the other coordinates, its ranks row-major in the run
        rest = [a for a in range(n) if a not in run]
        blocks = grid.transpose(rest + list(run)).reshape(
            -1, math.prod(shape[a] for a in run))
        for block in blocks:
            ranks = tuple(int(r) for r in block)
            if len(ranks) == _WORLD.size:
                pg = None
            else:
                pg = dist.new_group(list(ranks))
            if _WORLD.rank in ranks:
                mine = Group(name, ranks, pg)
        made.append(mine)
    mesh = Mesh(shape, axis_names, coords, tuple(made[:n]),
                tuple((tuple(axis_names[a] for a in run), g)
                      for run, g in zip(runs[n:], made[n:])))
    _MESHES[(shape, axis_names)] = mesh
    return mesh


def _count(name: str, group: Group | None, t0: float,
           result: torch.Tensor) -> None:
    """One call of collective ``name`` over ``group``, begun at ``t0``,
    whose result (its bytes counted) is ``result``."""
    dt = time.perf_counter() - t0
    nbytes = result.numel() * result.element_size()
    for key in (None, _WORLD_NAME if group is None else group.name):
        _CALLS.setdefault(key, dict.fromkeys(OPS, 0))[name] += 1
        _BYTES.setdefault(key, dict.fromkeys(OPS, 0))[name] += nbytes
        _SECONDS.setdefault(key, dict.fromkeys(OPS, 0.0))[name] += dt


def collective_counts(group: str | None = None) -> dict[str, int]:
    """Calls of each collective since the last reset: in all, or over the
    groups named ``group`` (an axis name, a run of axes such as
    ``"pod+data"``, or ``"world"`` for the default group)."""
    return dict(_CALLS.get(group, dict.fromkeys(OPS, 0)))


def collective_bytes(group: str | None = None) -> dict[str, int]:
    """Bytes of each collective's results since the last reset (in all,
    or over the groups named ``group``): the module docstring's
    convention."""
    return dict(_BYTES.get(group, dict.fromkeys(OPS, 0)))


def collective_groups() -> tuple[str, ...]:
    """The names of the groups a collective ran over since the last
    reset."""
    return tuple(sorted(k for k in _CALLS if k is not None))


def collective_seconds(group: str | None = None) -> dict[str, float]:
    """Host seconds spent in each collective since the last reset (in
    all, or over the groups named ``group``)."""
    return dict(_SECONDS.get(group, dict.fromkeys(OPS, 0.0)))


def reset_collective_counts() -> None:
    _CALLS.clear()
    _BYTES.clear()
    _SECONDS.clear()


def _pg(group: Group | None):
    return None if group is None else group.pg


class _AllReduceSum(torch.autograd.Function):
    """The all-reduce of a payload that requires grad; its backward is the
    all-reduce of the gradients (each rank's result feeds that rank's
    loss)."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        return _all_reduce(flat.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


def _all_reduce(flat: torch.Tensor, group: Group | None) -> torch.Tensor:
    t0 = time.perf_counter()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_pg(group))
    _count("all_reduce_sum", group, t0, flat)
    return flat


def all_reduce_sum(*tensors: torch.Tensor, group: Group | None = None):
    """The sum over the ranks of ``group`` (default: the world) of each
    tensor, in ONE collective: the tensors (one dtype) are flattened into
    one payload in argument order, reduced and split back. Returns one
    tensor, or a tuple for several. Differentiable when a tensor
    requires grad."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.requires_grad and torch.is_grad_enabled():
        flat = _AllReduceSum.apply(flat, group)
    else:
        flat = _all_reduce(flat, group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out[0] if len(out) == 1 else tuple(out)


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a collective's payload: contiguous, and under gloo on the
    host (gloo gathers, scatters and exchanges no CUDA tensor), by rule;
    under nccl on the rank's card."""
    w = _WORLD
    src = t.contiguous()
    if w is not None and w.backend == "gloo" and src.is_cuda:
        if not _STAGED_LOGGED:
            _STAGED_LOGGED.append(True)
            log.info("gloo: CUDA payloads of all-gathers, reduce-scatters "
                     "and all-to-alls go through their host copies")
        src = src.cpu()
    elif w is not None and w.backend == "nccl" and not src.is_cuda:
        src = src.to(w.device)
    return src


_STAGED_LOGGED: list = []


def _output_like(src: torch.Tensor, shape=None) -> torch.Tensor:
    """A collective's output buffer like ``src`` (of ``shape``): empty,
    or zeros in a fake world, whose collectives write nothing."""
    shape = src.shape if shape is None else shape
    if _WORLD is not None and _WORLD.backend == FAKE:
        return src.new_zeros(shape)
    return src.new_empty(shape)


def _size(group: Group | None) -> int:
    return dist.get_world_size() if group is None else group.size


def all_gather_rows(t: torch.Tensor, group: Group | None = None
                    ) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (default: the world) concatenated
    along dim 0 in the group's rank order, on ``t``'s device.

    gloo has no all_gather of CUDA tensors, so under gloo a CUDA tensor is
    gathered through its host copy; nccl gathers on the device, a host
    tensor through its copy on the rank's card.
    """
    t0 = time.perf_counter()
    src = _staged(t)
    parts = [_output_like(src) for _ in range(_size(group))]
    dist.all_gather(parts, src, group=_pg(group))
    out = torch.cat(parts).to(t.device)
    _count("all_gather_rows", group, t0, out)
    return out


def _gather(x: torch.Tensor, group: Group | None, dim: int) -> torch.Tensor:
    t0 = time.perf_counter()
    src = _staged(x.movedim(dim, 0))
    parts = [_output_like(src) for _ in range(_size(group))]
    dist.all_gather(parts, src, group=_pg(group))
    out = torch.cat(parts).to(x.device).movedim(0, dim)
    _count("all_gather", group, t0, out)
    return out


# reduce_scatter_tensor is deprecated under this name in newer torch
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


def _scatter(x: torch.Tensor, group: Group | None, dim: int) -> torch.Tensor:
    """The sum over the group, then this rank's chunk along ``dim``; a
    half-precision payload is summed in float32."""
    t0 = time.perf_counter()
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    wide = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    src = _staged(wide.movedim(dim, 0))
    shard = _output_like(src, (src.shape[0] // n, *src.shape[1:]))
    _reduce_scatter_single(shard, src, group=_pg(group))
    out = shard.to(device=x.device, dtype=x.dtype).movedim(0, dim)
    _count("reduce_scatter", group, t0, shard)
    return out


def _exchange(x: torch.Tensor, group: Group | None, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    t0 = time.perf_counter()
    n = _size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    src = _staged(x.movedim(split_dim, 0))
    out = _output_like(src)
    dist.all_to_all_single(out, src, group=_pg(group))
    parts = out.to(x.device).chunk(n, dim=0)
    out = torch.cat([p.movedim(0, split_dim) for p in parts], dim=concat_dim)
    _count("all_to_all", group, t0, out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g, ctx.group, concat_dim, split_dim), None, None, None


def all_gather(x: torch.Tensor, group: Group | None = None, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` (default: the world) concatenated
    along ``dim`` in the group's rank order. Its backward is
    ``reduce_scatter``."""
    return _AllGather.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group: Group | None = None,
                   dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, of which this rank
    keeps chunk ``i`` along ``dim``, i its place in the group. Its
    backward is ``all_gather``."""
    return _ReduceScatter.apply(x, group, dim)


def all_to_all(x: torch.Tensor, group: Group | None = None,
               split_dim: int = 0, concat_dim: int = 0) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` split along ``split_dim`` into
    one chunk a rank of ``group``, chunk j sent to rank j; the chunks
    received concatenated along ``concat_dim`` in rank order. Its
    backward is the reverse exchange."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def barrier() -> None:
    """Wait for every rank of the world, as after rank 0 writes a file the
    others read."""
    w = _WORLD
    if w is not None and w.backend == "nccl":
        dist.barrier(device_ids=[w.device.index])
    else:
        dist.barrier()


# --------------------------------------------------------------------------
# layouts on a mesh: a tensor's slices, a model's parameters
# --------------------------------------------------------------------------


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry: None -> (), ``"a"`` -> ("a",),
    ``("a", "b")`` as it is."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, entry) -> int:
    """The product of the sizes of the axes of one spec entry (1 for
    None). ``mesh``: anything with ``axis_names`` and ``shape``, the
    sizes by axis name (a mapping) or in ``axis_names``' order (a
    ``Mesh``'s tuple)."""
    sizes = mesh.shape
    if not isinstance(sizes, Mapping):
        sizes = dict(zip(mesh.axis_names, sizes))
    return math.prod(int(sizes[a]) for a in entry_axes(entry))


def fit_entry(entry, dim: int, mesh):
    """``entry`` where its axes' product divides ``dim``, else None: the
    reference's divisibility fallback to replication."""
    return entry if dim % axes_size(mesh, entry) == 0 else None


def fit_spec(spec, shape, mesh) -> tuple:
    """``spec`` padded with None to ``shape``'s rank, each entry fitted
    to its dim of the full ``shape`` (``fit_entry``)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(fit_entry(e, n, mesh) for e, n in zip(spec, shape))


def axes_group(mesh: Mesh, axes) -> Group | None:
    """The group of the ranks that differ from this one along ``axes``
    only: one axis's ``Group``, a run of consecutive axes' (``Mesh.spans``),
    or None (the default group) for every axis of the mesh in its order.
    Other sets of axes have no group (a mesh makes one an axis and a run
    of axes, and the world)."""
    axes = entry_axes(axes)
    if len(axes) == 1:
        return mesh.group(axes[0])
    if axes == tuple(mesh.axis_names):
        return None
    for span, group in mesh.spans:
        if span == axes:
            return group
    raise NotImplementedError(
        f"no group over the axes {axes} of the mesh {mesh.axis_names}: a "
        f"mesh makes one group an axis and a run of consecutive axes, and "
        f"the world")


def _entry_index(mesh: Mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's place, the count of places) along ``axes``, row-major
    in their order: the chunk of a dim split over them that it holds."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        n *= mesh.axis_size(a)
    return idx, n


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor of the full ``shape`` lies on a mesh: ``spec`` has
    one entry a dim (missing entries are None), None for a dim every rank
    holds whole, else the axis name (or names) the dim is split over in
    contiguous chunks, this rank's chunk its row-major place along them.
    Every split dim divides (``parallel.mesh``'s resolvers fit the
    specs)."""

    spec: tuple
    shape: tuple


def replica_axes(spec, mesh: Mesh) -> tuple[str, ...]:
    """The mesh's axes that no entry of ``spec`` splits over: the ranks
    along them hold the same slice."""
    used = {a for e in spec for a in entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a not in used)


def is_owner(spec, mesh: Mesh) -> bool:
    """Whether this rank is the first of the ranks holding its slice (its
    coordinate 0 along every replica axis), which counts the slice once
    where a sum over the world would count it once a copy."""
    return all(mesh.axis_index(a) == 0 for a in replica_axes(spec, mesh))


def slice_tensor(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a tensor every rank holds whole: each dim
    narrowed to its chunk along the axes of its entry (differentiable:
    the backward pads with zeros)."""
    for dim, e in enumerate(spec):
        axes = entry_axes(e)
        if axes:
            i, n = _entry_index(mesh, axes)
            c = t.shape[dim] // n
            t = t.narrow(dim, i * c, c)
    return t


def shard_tensor(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """``slice_tensor``'s slice as a tensor of its own (a copy)."""
    with torch.no_grad():
        return slice_tensor(t, spec, mesh).clone()


def gather_tensor(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from this rank's slice ``t`` laid out by ``spec``:
    one all-gather a split dim (differentiable: the backward
    reduce-scatters); ``gather_tensors``' for one tensor."""
    return gather_tensors([t], [spec], mesh)[0]


# gather_tensors' payload cap: a bucket of small slices is one collective;
# a large slice goes alone, so no copy of it is made on the way
BUCKET_BYTES = 64 * 2**20


def gather_tensors(tensors: list, specs: list, mesh: Mesh) -> list:
    """``gather_tensor`` of each tensor with its spec, in few all-gathers:
    an entry at a time (in the mesh's order of their axes), the slices
    split by it (one dtype) flattened into payloads of up to
    ``BUCKET_BYTES``, each gathered in one collective over the entry's
    group (``axes_group``) and put back in place (differentiable: a
    reduce-scatter a payload in the backward)."""
    out = list(tensors)
    entries = sorted({entry_axes(e) for spec in specs for e in spec} - {()},
                     key=lambda axes: [mesh.axis_names.index(a)
                                       for a in axes])
    for axes in entries:
        buckets: list[list] = []
        filling: dict[torch.dtype, list] = {}   # the open bucket a dtype
        filled: dict[torch.dtype, int] = {}
        for i, (t, spec) in enumerate(zip(out, specs)):
            for d, e in enumerate(spec):
                if entry_axes(e) != axes:
                    continue
                nbytes = t.numel() * t.element_size()
                if t.dtype not in filling or \
                        filled[t.dtype] + nbytes > BUCKET_BYTES:
                    filling[t.dtype] = []
                    filled[t.dtype] = 0
                    buckets.append(filling[t.dtype])
                filling[t.dtype].append((i, d))
                filled[t.dtype] += nbytes
        n = axes_size(mesh, axes)
        group = axes_group(mesh, axes)
        for items in buckets:
            flat = torch.cat([out[i].movedim(d, 0).reshape(-1)
                              for i, d in items]) if len(items) > 1 \
                else out[items[0][0]].movedim(items[0][1], 0).reshape(-1)
            whole = all_gather(flat, group, 0).view(n, -1)
            at = 0
            for i, d in items:
                t = out[i].movedim(d, 0)
                part = whole[:, at:at + t.numel()].reshape(n, *t.shape)
                out[i] = part.reshape(n * t.shape[0], *t.shape[1:]) \
                    .movedim(0, d)
                at += t.numel()
    return out


def shard_model(model: torch.nn.Module, mesh: Mesh, pspecs: dict
                ) -> torch.nn.Module:
    """Keep only this rank's slice of every parameter of ``model``, in
    place: ``pspecs`` maps each parameter's name to its resolved spec
    (``parallel.mesh.resolve_param_specs``). Records the layout as
    ``model.mesh_layout`` ({name: Sharding}) for the steps, the optimizer
    and ``unshard_model``. Returns ``model``."""
    if hasattr(model, "mesh_layout"):
        raise ValueError("shard_model: the model is sharded already")
    layout = {}
    for name, p in model.named_parameters():
        spec = tuple(pspecs[name])
        layout[name] = Sharding(spec, tuple(p.shape))
        p.data = shard_tensor(p.data, spec, mesh)
    model.mesh_layout = layout
    return model


def unshard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """The inverse of ``shard_model``: every parameter gathered whole on
    every rank, in place. Returns ``model``."""
    layout = model.__dict__.pop("mesh_layout")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = gather_tensor(p.data, layout[name].spec, mesh)
    return model


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
