"""Sampler API: ``SamplerSpec`` + ``build_sampler``.

Port of ``repro/core/ibp/api.py``:

    s = build_sampler(SamplerSpec(P=4, K_max=16, L=5), IBPHypers(), X)
    gs, ss = s.init()
    gs, ss = s.step(gs, ss)          # one full hybrid iteration
    gs, ss = s.stale(gs, ss)         # bounded-staleness pass (non-exact)
    ss = s.to_canonical(ss)          # HybridShard, (C?, P, N_p, K) layout
    ss = s.from_canonical(ss)        # back into the sampler's layout

Parallelism is two axes, ``chains`` ("none" | "vmap" | "mesh") x
``data`` ("vmap" | "shardmap"); the historical driver names are points
of that grid (``DRIVERS``). The spec keeps the reference's field names
and validation.

* ``data="vmap"``: P shards simulated on one device, and with
  ``chains="vmap"`` C independent chains.
* The distributed layouts run one process a device of the reference's
  mesh, joined by ``repro_torch.parallel`` (``torch.distributed.run
  --nproc-per-node N``, or ``parallel.spawn``). ``build_sampler``
  refuses them unless this process is a rank of a group of exactly
  ``devices_needed`` ranks, and lays the ranks out with
  ``parallel.make_mesh``:

  - ``data="shardmap"`` (``chains="none"``): P ranks, a ("data",) mesh;
    rank p holds shard p.
  - ``chains="mesh"`` x ``data="shardmap"``: C·P ranks, a ("chains",
    "data") mesh; rank (c, p) = divmod(rank, P) holds chain c's rows of
    shard p.
  - ``chains="mesh"`` x ``data="vmap"``: C ranks, a ("chains",) mesh;
    rank c holds all of chain c, its P shards simulated.

  A rank keeps its rows of X and its block of the state: a HybridGlobal
  (chain c's under ``chains="mesh"``, replicated over the data axis) and
  a HybridShard of leaves (1, N_p, ·) (``data="shardmap"``) or (P, N_p,
  ·). ``to_canonical`` gathers every rank's block, ``from_canonical``
  takes the rank's; ``to_canonical_global`` gathers the C chains'
  HybridGlobals into the chain-batched form and
  ``from_canonical_global`` takes chain c's (each a collective, at
  cadence only: no collective crosses the chain axis in ``step`` or
  ``stale``). ``sync`` selects the master sync: "staged" (three
  all-reduces over the data axis) or "fused" (one).

The kernel choice follows the device (CUDA kernels on a GPU, their plain
versions on the CPU). So ``backend`` ("jnp" or "pallas", the reference's
sweep implementation) is validated as the reference does and kept for
parity, and read by nothing. ``collapsed_backend`` selects the tail's
row step: ``"fast"`` (the default, as in the reference) runs the
carried scan with the rss flip and the carried G = HHᵀ, ``"pallas"`` the
carried scan with the mean-form flip (on the card each is one
``collapsed_scan`` launch), ``"ref"`` the O(K^3) oracle.
``k_live_buckets`` ("on" by default, as in the reference) is validated
and kept likewise, and read by nothing: in the reference it switches the
tail's carried G on, which the port's ``"fast"`` tail carries at either
value (``collapsed`` module docstring). The serial ``collapsed_sweep``
takes its own ``k_live_buckets``, where it selects the packed path.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import parallel, prng, tracing
from repro_torch.kernels.gibbs_flip import gibbs_flip_max_k

from .collapsed import COLLAPSED_BACKENDS, DEFAULT_REFRESH, K_LIVE_MODES
from .hybrid import (
    HybridGlobal,
    HybridShard,
    build_hybrid_fns,
    init_hybrid,
    init_multichain,
)
from .state import IBPHypers

CHAIN_MODES = ("none", "vmap", "mesh")
DATA_MODES = ("vmap", "shardmap")
SYNC_MODES = ("staged", "fused")
SWEEP_BACKENDS = ("jnp", "pallas")

# historical driver names -> (chains, data) axis modes
DRIVERS = {
    "vmap": ("none", "vmap"),
    "multichain": ("vmap", "vmap"),
    "shardmap": ("none", "shardmap"),
    "mesh": ("mesh", "shardmap"),
}

@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """All sampler knobs in one frozen, validated place."""

    # ---- model / state sizes
    P: int = 4                 # data shards (processors p of the paper)
    K_max: int = 32            # instantiated-feature capacity
    K_tail: int = 8            # in-flight tail features on p'
    K_init: int = 4            # features seeded at init
    alpha: float = 3.0
    sigma_x: float = 1.0
    sigma_a: float = 1.0
    # ---- kernel dispatch
    L: int = 5                 # sub-iterations per master sync
    backend: str = "jnp"       # validated; inert here (module docstring)
    collapsed_backend: str = "fast"  # tail row step: "ref"|"fast"|"pallas"
    chol_refresh: int = DEFAULT_REFRESH  # tail carry refactor cadence
    k_live_buckets: str = "on"  # validated; inert here (module docstring)
    # ---- parallelism layout (axes, not an enum)
    chains: str = "none"       # "none" | "vmap" | "mesh" (C ranks)
    data: str = "vmap"         # "vmap" | "shardmap" (P ranks)
    n_chains: int = 1          # C (chain axis size; 1 when chains="none")
    sync: str = "staged"       # "staged" | "fused" master sync (shardmap)
    stale_sync: int = 0        # bounded-staleness passes/iter (non-exact)
    # ---- run control (consumed by MCMCDriver, validated here)
    n_iters: int = 1000
    eval_every: int = 20
    ckpt_every: int = 100
    ckpt_dir: str = "artifacts/ckpt/ibp"
    overflow_every: int = 8    # overflow-detection cadence (host sync)
    k_tail_grow: int = 0       # adaptive K_tail: max automatic tail
    #                            doublings at checkpoint boundaries when
    #                            the tail-saturation counter fires
    #                            (0 = fixed K_tail; ceiling is K_max)
    seed: int = 0
    # ---- posterior-predictive harvest (SampleBank, consumed by MCMCDriver)
    harvest_every: int = 0     # harvest a posterior sample every this many
    #                            iterations (0 = off); chain-batched runs
    #                            harvest one sample per chain
    harvest_burn: float = 0.5  # fraction of the run discarded as burn-in
    #                            before harvesting starts
    bank_path: str = ""        # SampleBank npz ("" = <ckpt_dir>/bank.npz)

    def __post_init__(self):
        def bad(msg: str):
            raise ValueError(f"SamplerSpec: {msg}")

        if self.chains not in CHAIN_MODES:
            bad(f"chains={self.chains!r} not in {CHAIN_MODES}")
        if self.data not in DATA_MODES:
            bad(f"data={self.data!r} not in {DATA_MODES}")
        if (self.chains, self.data) == ("vmap", "shardmap"):
            bad("chains='vmap' cannot compose with data='shardmap' (vmap "
                "of a collective program is not a layout; use "
                "chains='mesh')")
        if self.n_chains < 1:
            bad(f"n_chains={self.n_chains} must be >= 1")
        if self.chains == "none" and self.n_chains != 1:
            bad(f"n_chains={self.n_chains} needs a chain axis; set "
                f"chains='vmap' or 'mesh' (driver='multichain'/'mesh')")
        if self.sync not in SYNC_MODES:
            bad(f"sync={self.sync!r} not in {SYNC_MODES}")
        if self.sync == "fused" and self.data != "shardmap":
            bad(f"sync='fused' is a collective schedule; data="
                f"{self.data!r} has no collectives (use data='shardmap')")
        if self.backend not in SWEEP_BACKENDS:
            bad(f"backend={self.backend!r} not in {SWEEP_BACKENDS}")
        if self.collapsed_backend not in COLLAPSED_BACKENDS:
            bad(f"collapsed_backend={self.collapsed_backend!r} not in "
                f"{COLLAPSED_BACKENDS}")
        if self.k_live_buckets not in K_LIVE_MODES:
            bad(f"k_live_buckets={self.k_live_buckets!r} not in "
                f"{K_LIVE_MODES}")
        if self.chol_refresh < 1:
            bad(f"chol_refresh={self.chol_refresh} must be >= 1")
        if self.P < 1:
            bad(f"P={self.P} must be >= 1")
        if self.L < 1:
            bad(f"L={self.L} must be >= 1")
        if self.K_max < 1 or self.K_tail < 1:
            bad(f"K_max={self.K_max}, K_tail={self.K_tail} must be >= 1")
        if self.K_tail > self.K_max:
            bad(f"K_tail={self.K_tail} exceeds K_max={self.K_max}: tail "
                f"promotion scatters into free instantiated slots, so a "
                f"tail wider than the capacity can try to place births "
                f"with no slot to hold them")
        if self.k_tail_grow < 0:
            bad(f"k_tail_grow={self.k_tail_grow} must be >= 0 "
                f"(0 disables adaptive K_tail growth)")
        if not 0 <= self.K_init <= self.K_max:
            bad(f"K_init={self.K_init} must be in [0, K_max={self.K_max}]")
        if self.stale_sync < 0:
            bad(f"stale_sync={self.stale_sync} must be >= 0 (a negative "
                f"value would silently skip the stale loop)")
        if self.overflow_every < 1:
            bad(f"overflow_every={self.overflow_every} must be >= 1")
        if self.n_iters < 1 or self.eval_every < 1 or self.ckpt_every < 1:
            bad(f"n_iters={self.n_iters}, eval_every={self.eval_every}, "
                f"ckpt_every={self.ckpt_every} must all be >= 1")
        if self.harvest_every < 0:
            bad(f"harvest_every={self.harvest_every} must be >= 0 "
                f"(0 disables harvesting)")
        if not 0.0 <= self.harvest_burn < 1.0:
            bad(f"harvest_burn={self.harvest_burn} must be in [0, 1) — a "
                f"burn fraction of the run, not an iteration count")

    # ---- derived views ----------------------------------------------------
    @property
    def driver(self) -> str:
        """Historical driver name for this layout (display/CLI)."""
        if self.chains == "mesh":
            return "mesh"
        if self.chains == "vmap":
            return "multichain"
        return "shardmap" if self.data == "shardmap" else "vmap"

    @property
    def chain_axis(self) -> bool:
        """Whether state leaves carry a leading chain axis."""
        return self.chains != "none"

    @property
    def devices_needed(self) -> int:
        """Real devices this layout requires (1 for pure-vmap layouts)."""
        c = self.n_chains if self.chains == "mesh" else 1
        p = self.P if self.data == "shardmap" else 1
        return c * p

    @classmethod
    def for_driver(cls, driver: str, **kw) -> "SamplerSpec":
        """Spec for a historical driver name (the DriverConfig shim path)."""
        if driver not in DRIVERS:
            raise ValueError(f"driver={driver!r} not in {tuple(DRIVERS)}")
        chains, data = DRIVERS[driver]
        return cls(chains=chains, data=data, **kw)

    def replace(self, **kw) -> "SamplerSpec":
        return dataclasses.replace(self, **kw)


class Sampler:
    """A built sampler: init/step/stale/canonicalize over the spec's
    layout, on one device (the rank's, under a distributed layout, with
    its place in ``mesh``). Construct via ``build_sampler``."""

    def __init__(self, spec: SamplerSpec, hyp: IBPHypers, X: Any,
                 device: torch.device, mesh: parallel.Mesh | None = None):
        self.spec = spec
        self.hyp = hyp
        self.device = device
        self.mesh = mesh
        X = np.asarray(X, np.float32)
        N = (X.shape[0] // spec.P) * spec.P
        if N == 0:
            raise ValueError(
                f"X has {X.shape[0]} rows; need at least P={spec.P}"
            )
        _check_capacity(spec, device)
        self.X_global = X[:N]
        self.N, self.D = N, X.shape[1]
        Xs = self.X_global.reshape(spec.P, N // spec.P, self.D)
        # the rank's coordinates: its chain c (chains="mesh") and its
        # shard p (data="shardmap"), whose rows alone are on the device
        self.chain = _coord(mesh, "chains")
        self.shard = _coord(mesh, "data")
        if self.shard is not None:
            Xs = Xs[self.shard:self.shard + 1]
        self.Xs = torch.as_tensor(Xs).to(device)
        self._fns = build_hybrid_fns(spec, hyp, N_global=N, mesh=mesh)

    @property
    def writes(self) -> bool:
        """Whether this process writes the run's files: rank 0 of a
        distributed layout, or the one process."""
        return self.mesh is None or parallel.world().rank == 0

    def with_spec(self, spec: SamplerSpec) -> "Sampler":
        """This sampler under another ``spec`` of the same layout, sharing
        the device copy of X and the mesh (a K_tail growth rebuilds the
        sampler without copying the data to the device again)."""
        def layout(sp: SamplerSpec) -> str:
            return ", ".join(f"{f}={getattr(sp, f)!r}"
                             for f in ("P", "data", "chains", "n_chains"))

        if layout(spec) != layout(self.spec):
            raise ValueError(f"with_spec: {layout(spec)} differ from this "
                             f"sampler's {layout(self.spec)}")
        _check_capacity(spec, self.device)
        out = copy.copy(self)
        out.spec = spec
        out._fns = build_hybrid_fns(spec, self.hyp, N_global=self.N,
                                    mesh=self.mesh)
        return out

    def init(self, key: torch.Tensor | None = None):
        """Fresh (gs, ss); ``key`` defaults to ``prng.key(spec.seed)``.
        With a chain axis, chain c starts from ``prng.split(key, C)[c]``.
        A rank of a distributed layout draws its chain's canonical state
        as the single-device layouts draw it on its device, and keeps its
        block."""
        spec = self.spec
        if key is None:
            key = prng.key(spec.seed)
        kw = dict(K_tail=spec.K_tail, alpha=spec.alpha, sigma_x=spec.sigma_x,
                  sigma_a=spec.sigma_a, K_init=spec.K_init)
        if self.chain is not None:
            key = prng.split(key, spec.n_chains)[self.chain]
        elif spec.chain_axis:
            return init_multichain(key, self.Xs, spec.n_chains, spec.K_max,
                                   **kw)
        if self.shard is not None:
            X_host = torch.as_tensor(self.X_global).view(spec.P, -1, self.D)
            gs, ss = init_hybrid(key, X_host, spec.K_max, device=self.device,
                                 **kw)
            return gs, self._block(ss, chained=False)
        return init_hybrid(key, self.Xs, spec.K_max, **kw)

    def step(self, gs: HybridGlobal, ss: HybridShard):
        """One full hybrid iteration (sub-iterations + master sync)."""
        with tracing.span("iteration"):
            return self._fns.step(self.Xs, gs, ss)

    def stale(self, gs: HybridGlobal, ss: HybridShard):
        """One bounded-staleness pass: sub-iterations, no sync (non-exact)."""
        return self._fns.stale(self.Xs, gs, ss)

    def to_canonical(self, ss: HybridShard) -> HybridShard:
        """Native state -> canonical (C?, P, N_p, K) HybridShard: the same
        on the single-device layouts; under a distributed layout every
        rank's block, gathered over the world in rank order, which is the
        mesh's (c, p) order (a collective: every rank calls it)."""
        if self.mesh is None:
            return ss
        out = [parallel.all_gather_rows(t)
               for t in (ss.Z, ss.Z_tail, ss.tail_active)]
        if self.chain is not None:
            C = self.spec.n_chains
            out = [t.view(C, -1, *t.shape[1:]) for t in out]
        return HybridShard(*out)

    def from_canonical(self, ss: HybridShard) -> HybridShard:
        """Canonical HybridShard -> state on the sampler's device (under a
        distributed layout, the rank's block)."""
        if self.mesh is None:
            return HybridShard(*(t.to(self.device) for t in
                                 (ss.Z, ss.Z_tail, ss.tail_active)))
        return self._block(ss, chained=self.chain is not None)

    def _block(self, ss: HybridShard, chained: bool) -> HybridShard:
        """The rank's block of a canonical HybridShard (``chained``: with
        its chain axis), a copy on the rank's device."""
        def take(t: torch.Tensor) -> torch.Tensor:
            if chained:
                t = t[self.chain]
            if self.shard is not None:
                t = t[self.shard:self.shard + 1]
            return t.to(self.device).clone()

        return HybridShard(*(take(t) for t in
                             (ss.Z, ss.Z_tail, ss.tail_active)))

    def to_canonical_global(self, gs: HybridGlobal) -> HybridGlobal:
        """Native HybridGlobal -> canonical: under chains="mesh" every
        chain's, gathered over the chain axis into the chain-batched form
        (a collective of every rank); elsewhere ``gs`` itself."""
        if self.chain is None:
            return gs
        return gather_global(gs, self.mesh.group("chains"))

    def from_canonical_global(self, gs: HybridGlobal) -> HybridGlobal:
        """Canonical HybridGlobal -> native: under chains="mesh" chain c's
        (a copy); elsewhere ``gs`` itself."""
        if self.chain is None:
            return gs
        return dataclasses.replace(gs, **{
            f.name: getattr(gs, f.name)[self.chain].clone()
            for f in dataclasses.fields(gs)})

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis's ranks under data="shardmap";
        ``t`` itself elsewhere (the rank holds every row)."""
        if self.shard is None:
            return t
        return parallel.all_reduce_sum(t, group=self.mesh.group("data"))

    def over_chains(self, t: torch.Tensor) -> torch.Tensor:
        """Rows of a per-chain value, one a chain this rank holds (dim 0),
        for every chain: under chains="mesh" the chain axis's ranks' rows
        gathered in chain order; elsewhere ``t`` itself (every chain is
        here)."""
        if self.chain is None:
            return t
        return parallel.all_gather_rows(t, group=self.mesh.group("chains"))


def _coord(mesh: parallel.Mesh | None, axis: str) -> int | None:
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.axis_index(axis)


def _as_f64(t: torch.Tensor) -> torch.Tensor:
    """A field's values as float64 on the host, exactly (float32, int32
    and the uint32 keys by their int32 bits)."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.reshape(-1).cpu().to(torch.float64)


def _from_f64(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return t.to(torch.int32).view(torch.uint32)
    return t.to(dtype)


def gather_global(gs: HybridGlobal, group: parallel.Group) -> HybridGlobal:
    """The HybridGlobals of ``group``'s ranks stacked on a leading axis in
    the group's order, in ONE gather: every field as float64 on the host
    (exact), each back in its dtype and on its device."""
    names = [f.name for f in dataclasses.fields(gs)]
    vals = [getattr(gs, n) for n in names]
    rows = parallel.all_gather_rows(
        torch.cat([_as_f64(v) for v in vals])[None], group=group)
    out, i = {}, 0
    for n, v in zip(names, vals):
        col = rows[:, i:i + v.numel()].reshape(-1, *v.shape)
        out[n] = _from_f64(col, v.dtype).to(v.device)
        i += v.numel()
    return HybridGlobal(**out)


def layout_mesh(spec: SamplerSpec) -> parallel.Mesh:
    """The reference's mesh of a distributed layout over the world's
    ranks: ("chains", "data") of C x P, ("chains",) of C, or ("data",)
    of P."""
    if spec.chains == "mesh" and spec.data == "shardmap":
        return parallel.make_mesh((spec.n_chains, spec.P),
                                  ("chains", "data"))
    if spec.chains == "mesh":
        return parallel.make_mesh((spec.n_chains,), ("chains",))
    return parallel.make_mesh((spec.P,), ("data",))


def _group_device(spec: SamplerSpec, device) -> torch.device:
    """A distributed layout: this process must be a rank of a group of
    exactly ``devices_needed`` (the reference's device-count check); its
    device is the rank's."""
    w = parallel.world()
    size = 0 if w is None else w.size
    need = spec.devices_needed
    C = spec.n_chains if spec.chains == "mesh" else 1
    P = spec.P if spec.data == "shardmap" else 1
    if spec.chains != "mesh":
        layout = f"data={spec.data!r} with P={spec.P}"
    else:
        layout = (f"chains='mesh' x data={spec.data!r} with n_chains={C}"
                  + (f", P={P}" if spec.data == "shardmap" else ""))
    if size != need:
        raise ValueError(
            f"{layout} needs a torch.distributed group of {need} ranks: "
            f"driver={spec.driver!r} needs {need} devices ({C} chains x {P} "
            f"data shards), one a rank; this process "
            + ("is in no group (0 ranks)" if w is None else
               f"is in a group of {size} ranks")
            + f" (run under torch.distributed.run --nproc-per-node {need}, "
              f"or repro_torch.parallel.spawn)")
    if device is not None:
        dev = torch.device(device)
        if dev.type != w.device.type or dev.index not in (None,
                                                           w.device.index):
            raise ValueError(f"device={dev} is not this rank's device "
                             f"{w.device}")
    return _device.resolve(w.device)


def _check_capacity(spec: SamplerSpec, device: torch.device) -> None:
    if device.type == "cuda" and spec.K_max > gibbs_flip_max_k(device):
        raise ValueError(
            f"SamplerSpec: K_max={spec.K_max} exceeds the "
            f"{gibbs_flip_max_k(device)} columns the sweep kernel takes "
            f"on {device}")


def build_sampler(spec: SamplerSpec, hyp: IBPHypers | None = None,
                  X: Any = None, device: str | torch.device | None = None
                  ) -> Sampler:
    """Validated spec + hypers + data -> Sampler on ``device`` (default
    ``cuda``; raises when no GPU is visible — pass ``device="cpu"`` for
    the plain PyTorch path). Under a distributed layout (data="shardmap"
    or chains="mesh") the device is the rank's (``parallel.init_group``;
    ``device``, if given, must name it), and every rank of the group
    calls this, in one order (it makes the mesh's groups)."""
    if X is None:
        raise ValueError("build_sampler needs the data matrix X")
    if spec.data == "shardmap" or spec.chains == "mesh":
        dev = _group_device(spec, device)
        return Sampler(spec, hyp or IBPHypers(), X, dev, layout_mesh(spec))
    return Sampler(spec, hyp or IBPHypers(), X, _device.resolve(device))
