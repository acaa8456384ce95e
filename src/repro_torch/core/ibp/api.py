"""Sampler API: ``SamplerSpec`` + ``build_sampler``.

Port of ``repro/core/ibp/api.py`` for the single-device layout
(``chains="none"`` x ``data="vmap"``: P shards simulated on one device):

    s = build_sampler(SamplerSpec(P=4, K_max=16, L=5), IBPHypers(), X)
    gs, ss = s.init()
    gs, ss = s.step(gs, ss)          # one full hybrid iteration
    ss = s.to_canonical(ss)          # HybridShard, (P, N_p, K) layout
    ss = s.from_canonical(ss)        # back onto the sampler's device

The spec keeps the reference's field names and validation for what the
port supports. Values that select work not yet ported raise
``NotImplementedError`` naming the ROADMAP item that brings them. The
kernel choice follows the device (CUDA kernels on a GPU, their plain
versions on the CPU), so the reference's ``backend`` is not a knob here.
``collapsed_backend`` selects the tail's row step: ``"fast"`` (the
default, as in the reference) runs the carried scan with the rss flip
and the carried G = HHᵀ, ``"pallas"`` the carried scan with the
mean-form flip (on the card each is one ``collapsed_scan`` launch),
``"ref"`` the O(K^3) oracle. ``k_live_buckets`` ("on" by default, as in
the reference) is validated and kept for parity with the reference's
spec, and read by nothing: in the reference it switches the tail's
carried G on, which the port's ``"fast"`` tail carries at either value
(``collapsed`` module docstring). The serial ``collapsed_sweep`` takes
its own ``k_live_buckets``, where it selects the packed path.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.kernels.gibbs_flip import gibbs_flip_max_k

from .collapsed import COLLAPSED_BACKENDS, DEFAULT_REFRESH, K_LIVE_MODES
from .hybrid import (
    HybridGlobal,
    HybridShard,
    _hybrid_iteration_body,
    init_hybrid,
)
from .state import IBPHypers

CHAIN_MODES = ("none", "vmap", "mesh")
DATA_MODES = ("vmap", "shardmap")

_LATER = {
    "chains": "ROADMAP queue 1 item 8 (multichain and mesh layouts)",
    "data": "ROADMAP queue 1 item 8 (multichain and mesh layouts)",
    "stale_sync": "ROADMAP queue 1 item 8 (the bounded-staleness body)",
    "driver": "ROADMAP queue 1 item 8 (multichain and mesh layouts)",
    "n_chains": "ROADMAP queue 1 item 8 (multichain and mesh layouts)",
    "sync": "ROADMAP queue 1 item 8 (the fused master sync)",
}


def _not_yet(field: str, value, owner: str = "SamplerSpec") -> None:
    raise NotImplementedError(
        f"{owner}: {field}={value!r} is not ported yet; it comes with "
        f"{_LATER[field]}"
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
    collapsed_backend: str = "fast"  # tail row step: "ref"|"fast"|"pallas"
    chol_refresh: int = DEFAULT_REFRESH  # tail carry refactor cadence
    k_live_buckets: str = "on"  # validated; inert here (module docstring)
    # ---- parallelism layout
    chains: str = "none"       # only "none" is ported
    data: str = "vmap"         # only "vmap" is ported
    stale_sync: int = 0        # only 0 is ported
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
    #                            iterations (0 = off)
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
            bad(f"stale_sync={self.stale_sync} must be >= 0")
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
        if self.chains != "none":
            _not_yet("chains", self.chains)
        if self.data != "vmap":
            _not_yet("data", self.data)
        if self.stale_sync > 0:
            _not_yet("stale_sync", self.stale_sync)

    def replace(self, **kw) -> "SamplerSpec":
        return dataclasses.replace(self, **kw)


class Sampler:
    """A built sampler on one device. Construct via ``build_sampler``."""

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
        self.Xs = torch.as_tensor(
            self.X_global.reshape(spec.P, N // spec.P, self.D)).to(device)

    def with_spec(self, spec: SamplerSpec) -> "Sampler":
        """This sampler under another ``spec`` of the same P, sharing the
        device copy of X (a K_tail growth rebuilds the sampler without
        copying the data to the device again)."""
        if spec.P != self.spec.P:
            raise ValueError(f"with_spec: P={spec.P} differs from this "
                             f"sampler's P={self.spec.P}")
        _check_capacity(spec, self.device)
        out = copy.copy(self)
        out.spec = spec
        return out

    def init(self, key: torch.Tensor | None = None):
        """Fresh (gs, ss); ``key`` defaults to ``prng.key(spec.seed)``."""
        spec = self.spec
        if key is None:
            key = prng.key(spec.seed)
        return init_hybrid(key, self.Xs, spec.K_max, K_tail=spec.K_tail,
                           alpha=spec.alpha, sigma_x=spec.sigma_x,
                           sigma_a=spec.sigma_a, K_init=spec.K_init)

    def step(self, gs: HybridGlobal, ss: HybridShard):
        """One full hybrid iteration (sub-iterations + master sync)."""
        return _hybrid_iteration_body(self.Xs, gs, ss, self.hyp, self.spec.L,
                                      float(self.N), self.spec.chol_refresh,
                                      self.spec.collapsed_backend)

    def to_canonical(self, ss: HybridShard) -> HybridShard:
        """Native state -> canonical (P, N_p, K) HybridShard (the same
        on the single-device layout)."""
        return ss

    def from_canonical(self, ss: HybridShard) -> HybridShard:
        """Canonical HybridShard -> state on the sampler's device."""
        return HybridShard(*(t.to(self.device) for t in
                             (ss.Z, ss.Z_tail, ss.tail_active)))


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
    the plain PyTorch path)."""
    if X is None:
        raise ValueError("build_sampler needs the data matrix X")
    return Sampler(spec, hyp or IBPHypers(), X, _device.resolve(device))
