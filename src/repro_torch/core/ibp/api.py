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
* ``data="shardmap"`` (``chains="none"``): P processes, rank p holding
  shard p on its own device, joined by ``repro_torch.parallel``
  (``torch.distributed.run --nproc-per-node P``, or
  ``parallel.spawn``). ``build_sampler`` refuses it unless this process
  is a rank of a group of exactly P. A rank keeps its rows of X and Z;
  ``to_canonical`` gathers every rank's rows, ``from_canonical`` takes
  the rank's block. ``sync`` selects the master sync: "staged" (three
  all-reduces) or "fused" (one).
* ``chains="mesh"`` raises ``NotImplementedError`` naming the ROADMAP
  item that brings it.

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
from repro_torch import parallel, prng
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

def _not_yet(field: str, value) -> None:
    """The chains x data mesh: not ported yet."""
    raise NotImplementedError(
        f"SamplerSpec: {field}={value!r} is not ported yet; it comes with "
        f"ROADMAP queue 1 item 8b (the torch.distributed layouts)"
    )


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
    chains: str = "none"       # "none" | "vmap" ("mesh": item 8b)
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
        if self.chains == "mesh":
            _not_yet("chains", self.chains)

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
    layout, on one device (the rank's, under data="shardmap"). Construct
    via ``build_sampler``."""

    def __init__(self, spec: SamplerSpec, hyp: IBPHypers, X: Any,
                 device: torch.device):
        self.spec = spec
        self.hyp = hyp
        self.device = device
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
        # under shardmap the device holds only this rank's rows
        self.rank = (parallel.world().rank if spec.data == "shardmap"
                     else None)
        if self.rank is not None:
            Xs = Xs[self.rank:self.rank + 1]
        self.Xs = torch.as_tensor(Xs).to(device)
        self._fns = build_hybrid_fns(spec, hyp, N_global=N)

    def with_spec(self, spec: SamplerSpec) -> "Sampler":
        """This sampler under another ``spec`` of the same P and layout,
        sharing the device copy of X (a K_tail growth rebuilds the sampler
        without copying the data to the device again)."""
        if (spec.P, spec.data) != (self.spec.P, self.spec.data):
            raise ValueError(
                f"with_spec: P={spec.P}, data={spec.data!r} differ from this "
                f"sampler's P={self.spec.P}, data={self.spec.data!r}")
        _check_capacity(spec, self.device)
        out = copy.copy(self)
        out.spec = spec
        out._fns = build_hybrid_fns(spec, self.hyp, N_global=self.N)
        return out

    def init(self, key: torch.Tensor | None = None):
        """Fresh (gs, ss); ``key`` defaults to ``prng.key(spec.seed)``.
        With a chain axis, chain c starts from ``prng.split(key, C)[c]``.
        Under shardmap every rank draws the canonical state the vmap
        layout draws on its device, and keeps its block."""
        spec = self.spec
        if key is None:
            key = prng.key(spec.seed)
        kw = dict(K_tail=spec.K_tail, alpha=spec.alpha, sigma_x=spec.sigma_x,
                  sigma_a=spec.sigma_a, K_init=spec.K_init)
        if spec.chain_axis:
            return init_multichain(key, self.Xs, spec.n_chains, spec.K_max,
                                   **kw)
        if self.rank is not None:
            X_host = torch.as_tensor(self.X_global).view(spec.P, -1, self.D)
            gs, ss = init_hybrid(key, X_host, spec.K_max, device=self.device,
                                 **kw)
            return gs, self.from_canonical(ss)
        return init_hybrid(key, self.Xs, spec.K_max, **kw)

    def step(self, gs: HybridGlobal, ss: HybridShard):
        """One full hybrid iteration (sub-iterations + master sync)."""
        return self._fns.step(self.Xs, gs, ss)

    def stale(self, gs: HybridGlobal, ss: HybridShard):
        """One bounded-staleness pass: sub-iterations, no sync (non-exact)."""
        return self._fns.stale(self.Xs, gs, ss)

    def to_canonical(self, ss: HybridShard) -> HybridShard:
        """Native state -> canonical (C?, P, N_p, K) HybridShard: the same
        on the single-device layouts; under shardmap every rank's rows,
        gathered (a collective: every rank calls it)."""
        if self.rank is None:
            return ss
        return HybridShard(*(parallel.all_gather_rows(t) for t in
                             (ss.Z, ss.Z_tail, ss.tail_active)))

    def from_canonical(self, ss: HybridShard) -> HybridShard:
        """Canonical HybridShard -> state on the sampler's device (under
        shardmap, the rank's block)."""
        leaves = (ss.Z, ss.Z_tail, ss.tail_active)
        if self.rank is not None:
            r = self.rank
            return HybridShard(*(t[r:r + 1].to(self.device).clone()
                                 for t in leaves))
        return HybridShard(*(t.to(self.device) for t in leaves))


def _shardmap_device(spec: SamplerSpec, device) -> torch.device:
    """data="shardmap": this process must be a rank of a group of exactly
    P (the reference's device-count check); its device is the rank's."""
    w = parallel.world()
    size = 0 if w is None else w.size
    if size != spec.P:
        raise ValueError(
            f"data='shardmap' with P={spec.P} needs a torch.distributed group "
            f"of {spec.P} ranks, one a shard; this process "
            + ("is in no group (0 ranks)" if w is None else
               f"is in a group of {size} ranks")
            + f" (run under torch.distributed.run --nproc-per-node {spec.P}, "
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
    the plain PyTorch path). Under data="shardmap" the device is the
    rank's (``parallel.init_group``); ``device``, if given, must name
    it."""
    if X is None:
        raise ValueError("build_sampler needs the data matrix X")
    dev = (_shardmap_device(spec, device) if spec.data == "shardmap"
           else _device.resolve(device))
    return Sampler(spec, hyp or IBPHypers(), X, dev)
