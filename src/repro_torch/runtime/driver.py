"""MCMC driver: run loop, checkpoint/restart, capacity restarts, adaptive
K_tail, eval records — over a ``Sampler`` built by ``build_sampler``.

Port of ``repro/runtime/driver.py`` for ``driver="vmap"`` (one chain
on one device), ``driver="multichain"`` (C chains on one device, every
state leaf with a leading chain axis), ``driver="shardmap"`` (P ranks,
one shard each) and ``driver="mesh"`` (C·P ranks, rank (c, p) chain c's
rows of shard p); under the last two every rank runs the driver:

* every ``ckpt_every`` iterations the full sampler state (global params,
  Z in global (N, K) layout, the PRNG key) is written atomically in the
  reference's npz layout; a restart resumes bitwise on the same device.
* overflow (a promoted tail feature dropped for lack of a free K_max slot,
  ``gs.overflow``) is checked every ``overflow_every`` iterations; the
  driver then checkpoints and raises, asking for a restart with a larger
  K_max. A restart under a larger K_max pads the checkpoint's feature
  axis with empty slots; under a smaller one it compacts the live
  features into the new capacity and refuses when they do not fit.
* adaptive K_tail (``k_tail_grow``): new tail saturation at a
  checkpoint boundary (the most of any chain) doubles K_tail in-process.
* ``stale_sync`` bounded-staleness passes (sub-iterations without the
  master sync; non-exact) run before each full iteration.
* eval records hold K, alpha, sigma_x, the train and held-out joint
  log-likelihoods, K_tail, tail_sat and split-R-hat / ESS / MCSE of the
  per-iteration sigma_x and K+ traces; with chains, the means over
  chains and the per-chain lists (``K_chains``, ``sigma_x_chains``,
  ``joint_ll_train_chains``, ``tail_sat_chains``), and R-hat across
  chains.
* chains: a checkpoint keeps the chain axis (``Z_global`` (C, N, K));
  a chainless checkpoint under a chained spec, or the reverse, or a
  changed ``n_chains`` is refused loudly; overflow is the most of any
  chain; a harvest adds one sample per chain.
* posterior-predictive harvest (``harvest_every``): past the burn-in,
  every ``harvest_every`` iterations the post-sync draw of the global
  parameters goes into a ``BankBuilder`` on the host; the built
  ``SampleBank`` is saved (``bank_path``) before each checkpoint, and a
  restart extends the builder from the saved bank and drops the samples
  past the restored step, so each draw is in the bank once.
* shardmap and mesh: the checkpoint's ``Z_global`` ((C,) N, K) is
  gathered from every rank, and under the mesh the chains' HybridGlobals
  into the chain-batched form; only rank 0 writes the checkpoint and the
  bank, then every rank waits at a barrier. Every rank restores the same
  file and takes its block, so a checkpoint resumes under any layout of
  the same chain axis (shardmap and vmap; mesh and multichain) and under
  another P. A chain's ``joint_ll_train`` is the sum over its data
  ranks of each rank's part. Under the mesh, what the driver reads of
  the chains (the eval record, the traces' R-hat and ESS, overflow,
  tail saturation, the harvest) is gathered over the chain axis at its
  cadence; ``step`` and ``stale`` make no collective across it. Only
  rank 0 keeps the harvest's ``BankBuilder`` (``bank`` is None on the
  other ranks).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import parallel, prng, tracing
from repro_torch.checkpoint import restore, save_pytree
from repro_torch.core.ibp import convergence
from repro_torch.core.ibp.api import (
    DRIVERS,
    SWEEP_BACKENDS,
    SYNC_MODES,
    SamplerSpec,
    build_sampler,
)
from repro_torch.core.ibp.collapsed import (
    COLLAPSED_BACKENDS,
    DEFAULT_REFRESH,
    K_LIVE_MODES,
)
from repro_torch.core.ibp.hybrid import HybridGlobal, HybridShard
from repro_torch.core.ibp.predict import (
    BankBuilder,
    SampleBank,
    heldout_joint_loglik,
    train_joint_loglik,
)
from repro_torch.core.ibp.state import IBPHypers


@dataclasses.dataclass
class DriverConfig:
    """The reference's older construction surface, mapped onto a
    ``SamplerSpec`` by ``to_spec``; it keeps the reference's fields and
    defaults, so ``DriverConfig()`` builds.

    ``driver`` maps onto the spec's ``chains`` x ``data`` axes
    (``DRIVERS``), and a value the reference rejects raises
    ``ValueError``. ``backend`` passes on to the spec, where it is
    inert (the device chooses the kernels).
    """

    P: int = 4
    K_max: int = 32
    K_tail: int = 8
    L: int = 5
    n_iters: int = 1000
    ckpt_every: int = 100
    ckpt_dir: str = "artifacts/ckpt/ibp"
    eval_every: int = 20
    seed: int = 0
    alpha: float = 3.0
    sigma_x: float = 1.0
    sigma_a: float = 1.0
    K_init: int = 4
    backend: str = "jnp"       # "jnp" | "pallas" for the uncollapsed sweep
    stale_sync: int = 0        # >0 = bounded staleness (non-exact)
    driver: str = "vmap"       # "vmap"|"multichain"|"shardmap"|"mesh"
    n_chains: int = 1          # chain count (multichain / mesh)
    sync: str = "staged"       # "staged" | "fused" master sync (collective)
    overflow_every: int = 8    # overflow-detection cadence (host sync)
    k_tail_grow: int = 0       # adaptive K_tail: max tail doublings (0=off)
    collapsed_backend: str = "fast"  # "ref" | "fast" | "pallas" tail step
    chol_refresh: int = DEFAULT_REFRESH  # tail carry refactor cadence
    k_live_buckets: str = "on"  # occupancy-adaptive packing
    harvest_every: int = 0     # SampleBank harvest cadence (0 = off)
    harvest_burn: float = 0.5  # burn-in fraction before harvesting
    bank_path: str = ""        # bank npz ("" = <ckpt_dir>/bank.npz)

    def to_spec(self) -> SamplerSpec:
        for field, value, allowed in (
                ("driver", self.driver, tuple(DRIVERS)),
                ("backend", self.backend, SWEEP_BACKENDS),
                ("collapsed_backend", self.collapsed_backend,
                 COLLAPSED_BACKENDS),
                ("k_live_buckets", self.k_live_buckets, K_LIVE_MODES),
                ("sync", self.sync, SYNC_MODES)):
            if value not in allowed:
                raise ValueError(f"DriverConfig: {field}={value!r} not in "
                                 f"{allowed}")
        if not 0.0 <= self.harvest_burn < 1.0:
            raise ValueError(f"DriverConfig: harvest_burn="
                             f"{self.harvest_burn} must be in [0, 1)")
        return SamplerSpec.for_driver(
            self.driver, P=self.P, K_max=self.K_max, K_tail=self.K_tail,
            K_init=self.K_init, alpha=self.alpha, sigma_x=self.sigma_x,
            sigma_a=self.sigma_a, L=self.L, backend=self.backend,
            collapsed_backend=self.collapsed_backend,
            chol_refresh=self.chol_refresh,
            k_live_buckets=self.k_live_buckets, n_chains=self.n_chains,
            sync=self.sync, stale_sync=self.stale_sync, n_iters=self.n_iters,
            eval_every=self.eval_every, ckpt_every=self.ckpt_every,
            ckpt_dir=self.ckpt_dir, overflow_every=self.overflow_every,
            k_tail_grow=self.k_tail_grow, seed=self.seed,
            harvest_every=self.harvest_every,
            harvest_burn=self.harvest_burn, bank_path=self.bank_path,
        )


def as_spec(cfg: DriverConfig | SamplerSpec) -> SamplerSpec:
    """Normalize either config surface to a validated SamplerSpec."""
    return cfg.to_spec() if isinstance(cfg, DriverConfig) else cfg


class MCMCDriver:
    """Runs a built Sampler with checkpoint/restart."""

    def __init__(self, X: np.ndarray, cfg: DriverConfig | SamplerSpec,
                 hyp: IBPHypers | None = None,
                 X_eval: np.ndarray | None = None,
                 device: str | torch.device | None = None):
        spec = as_spec(cfg)
        self.spec = spec
        self.cfg = spec  # the reference's alias: run knobs live on the spec
        self.hyp = hyp or IBPHypers()
        self.sampler = build_sampler(spec, self.hyp, X, device=device)
        self.device = self.sampler.device
        self.X_global = self.sampler.X_global
        self.N = self.sampler.N
        self.X_eval = (None if X_eval is None else torch.as_tensor(
            np.asarray(X_eval, np.float32)).to(self.device))
        self.history: list[dict[str, Any]] = []
        # per-iteration scalar traces, kept on the device until an eval
        self.trace: dict[str, list] = {"sigma_x": [], "K": []}
        # adaptive K_tail: doublings so far, and the tail_sat watermark at
        # the last checkpoint boundary (growth fires on new saturation only)
        self._tail_growths = 0
        self._sat_mark = 0
        # the harvest's host-side accumulator, kept by the process that
        # writes the files (rank 0 of a distributed layout); the bank is
        # its own self-describing file beside the checkpoints
        self.bank_builder = (BankBuilder(spec.K_max)
                             if spec.harvest_every > 0
                             and self.sampler.writes else None)
        self._bank: SampleBank | None = None

    # ---- state <-> checkpoint layout (global Z) --------------------------
    def _to_ckpt(self, gs: HybridGlobal, ss: HybridShard) -> dict:
        # tail buffers are not serialized: checkpoints are written
        # post-sync, where tails are always cleared
        *lead, P, N_p, K = ss.Z.shape
        return {"gs": gs, "Z_global": ss.Z.reshape(*lead, P * N_p, K),
                "meta": {"it": gs.it}}

    def _save(self, gs: HybridGlobal, ss: HybridShard, step: int) -> None:
        """The bank, then the checkpoint of the canonical state: a crash
        between the two writes rewinds to the older checkpoint, whose
        re-run harvests again. Under a distributed layout every rank
        gathers the state, rank 0 alone writes, and every rank waits for
        the write."""
        s = self.sampler
        gs, ss = s.to_canonical_global(gs), s.to_canonical(ss)
        if s.writes:
            if self.bank_builder is not None and len(self.bank_builder):
                self.save_bank()
            save_pytree(self.spec.ckpt_dir, self._to_ckpt(gs, ss), step)
        if s.mesh is not None:
            parallel.barrier()

    def _shrink_features(self, gs: HybridGlobal, Zg: torch.Tensor,
                         K_new: int) -> tuple[HybridGlobal, torch.Tensor]:
        """Shrink restart: compact a checkpoint's feature axis into a
        smaller K_max. The kept columns are every live feature plus the
        lowest-index free slots, in ascending order, so the posterior
        state is untouched and only dead slots are dropped. Refuses when
        the live features do not fit. A chain-batched checkpoint compacts
        per chain (each chain has its own live set)."""
        chained = gs.active.dim() == 2
        A, pi, act, Z = (t if chained else t[None]
                         for t in (gs.A, gs.pi, gs.active, Zg))
        cols = []
        for c, a in enumerate(act):
            live = torch.nonzero(a > 0.5).flatten()
            if live.numel() > K_new:
                who = (f"chain {c} of the checkpoint" if chained
                       else "the checkpoint")
                raise ValueError(
                    f"cannot shrink to K_max={K_new}: {who} carries "
                    f"{live.numel()} live features; restart with "
                    f"K_max >= {live.numel()}"
                )
            free = torch.nonzero(a <= 0.5).flatten()
            cols.append(torch.sort(torch.cat(
                [live, free[:K_new - live.numel()]]))[0])

        def pick(t: torch.Tensor, dim: int) -> torch.Tensor:
            out = torch.stack([t[i].index_select(dim, c)
                               for i, c in enumerate(cols)])
            return out if chained else out[0]

        gs = dataclasses.replace(gs, A=pick(A, 0), pi=pick(pi, 0),
                                 active=pick(act, 0))
        return gs, pick(Z, 1)

    def _from_ckpt(self, blob: dict) -> tuple[HybridGlobal, HybridShard]:
        """Checkpoint -> (gs, ss) under this driver's spec. A checkpoint of
        another K_max is grown (empty slots appended, overflow reset) or
        shrunk (``_shrink_features``; overflow kept, as the reference
        does). The chain axis must match the spec: a chainless checkpoint
        under a chained spec, the reverse, or another ``n_chains`` is
        refused. Tail buffers are rebuilt empty at the configured K_tail:
        checkpoints are written post-sync, where tails are cleared."""
        spec = self.spec
        gs: HybridGlobal = blob["gs"]
        Zg = blob["Z_global"]
        K_ck = Zg.shape[-1]
        if K_ck > spec.K_max:
            gs, Zg = self._shrink_features(gs, Zg, spec.K_max)
        if K_ck < spec.K_max:
            grow = spec.K_max - K_ck
            Zg = F.pad(Zg, (0, grow))
            gs = dataclasses.replace(
                gs, A=F.pad(gs.A, (0, 0, 0, grow)), pi=F.pad(gs.pi, (0, grow)),
                active=F.pad(gs.active, (0, grow)),
                overflow=torch.zeros_like(gs.overflow))
        *lead, N, K = Zg.shape
        if N != self.N:
            raise ValueError(
                f"checkpoint has N={N} observations but this driver "
                f"truncated the data to N={self.N} (P={spec.P}); pick a P "
                f"that keeps N={N}"
            )
        # the chain count is part of the state: it cannot change across a
        # restart, and a chainless state never restores as a chained one
        if spec.chain_axis:
            if not lead or lead[0] != spec.n_chains:
                raise ValueError(
                    f"checkpoint chain axis {tuple(lead) or 'absent'} does "
                    f"not match configured n_chains={spec.n_chains}"
                )
        elif lead:
            raise ValueError(
                f"checkpoint carries a chain axis {tuple(lead)}; restore it "
                f"with driver='multichain' and n_chains={lead[0]}"
            )
        P = spec.P
        z = torch.zeros((*lead, P, N // P, spec.K_tail), dtype=Zg.dtype,
                        device=Zg.device)
        return gs, HybridShard(Z=Zg.reshape(*lead, P, N // P, K), Z_tail=z,
                               tail_active=z[..., 0, :].clone())

    def _template(self):
        gs, ss = self.sampler.init()
        return self._to_ckpt(gs, ss)

    # ---- posterior-predictive harvest ----------------------------------
    @property
    def bank_path(self) -> str:
        return self.spec.bank_path or os.path.join(self.spec.ckpt_dir,
                                                   "bank.npz")

    @property
    def bank(self) -> SampleBank | None:
        """The harvested samples as a ``SampleBank`` on the driver's device
        (None before the first harvest), rebuilt when samples arrived."""
        b = self.bank_builder
        if b is None or len(b) == 0:
            return self._bank
        if self._bank is None or self._bank.S != len(b):
            self._bank = b.build(self.device)
        return self._bank

    def save_bank(self) -> str | None:
        """Build and save the bank; its path, or None if nothing was
        harvested."""
        bank = self.bank
        return None if bank is None else bank.save(self.bank_path)

    # ---- adaptive K_tail --------------------------------------------------
    def _maybe_grow_tail(self, gs: HybridGlobal, ss: HybridShard
                         ) -> tuple[HybridGlobal, HybridShard, bool]:
        """Double K_tail (up to K_max, at most ``k_tail_grow`` times) when
        new tail saturation (``gs.tail_sat``: accepted births vetoed by
        K_tail capacity; with chains, the most of any chain) accrued
        since the last checkpoint boundary. Runs
        at a post-sync checkpoint boundary, where tails are empty, so the
        sampler is rebuilt with empty tail buffers at the new width and the
        posterior state is untouched; the counter is zeroed so the next
        decision sees only post-growth saturation. Reading ``tail_sat``
        waits for the iteration. Returns (gs, ss, grew)."""
        spec = self.spec
        with tracing.transfer("tail_sat"):
            sat = int(self.sampler.over_chains(gs.tail_sat.reshape(-1)).max())
        grew = False
        if (self._tail_growths < spec.k_tail_grow
                and spec.K_tail < spec.K_max and sat > self._sat_mark):
            new_tail = min(2 * spec.K_tail, spec.K_max)
            spec = spec.replace(K_tail=new_tail)
            self.spec = self.cfg = spec
            self.sampler = self.sampler.with_spec(spec)
            z = ss.Z.new_zeros((*ss.Z.shape[:-1], new_tail))
            ss = HybridShard(Z=ss.Z, Z_tail=z,
                             tail_active=z[..., 0, :].clone())
            gs = dataclasses.replace(gs,
                                     tail_sat=torch.zeros_like(gs.tail_sat))
            self._tail_growths += 1
            grew = True
            sat = 0
        self._sat_mark = sat
        return gs, ss, grew

    # ---- main loop --------------------------------------------------------
    def run(self, n_iters: int | None = None,
            on_eval: Callable[[dict], None] | None = None,
            crash_at: int | None = None):
        """Main loop. ``crash_at`` raises mid-run (for restart tests)."""
        spec = self.spec
        sampler = self.sampler
        n_iters = n_iters or spec.n_iters
        restored = restore(spec.ckpt_dir, self._template())
        b = self.bank_builder
        if restored is not None:
            gs, ss = self._from_ckpt(restored[0])
            gs = sampler.from_canonical_global(gs)
            ss = sampler.from_canonical(ss)
            start = int(restored[1])
            # a restart continues the harvest from the saved bank, less
            # the samples past the restored step: those iterations re-run
            # and harvest again
            if b is not None and len(b) == 0 and os.path.exists(
                    self.bank_path):
                b.extend_from(SampleBank.load(self.bank_path, "cpu"))
        else:
            start = 0
            gs, ss = sampler.init(prng.key(spec.seed))
        if b is not None:
            b.prune_after(start)
            self._bank = None

        t0 = time.perf_counter()
        for it in range(start, n_iters):
            with tracing.span("driver"):
                if crash_at is not None and it == crash_at:
                    raise RuntimeError(f"injected crash at iteration {it}")
                for _ in range(spec.stale_sync):
                    gs, ss = sampler.stale(gs, ss)
                gs, ss = sampler.step(gs, ss)
                self._record_trace(gs)
                last = it == n_iters - 1
                if (spec.harvest_every > 0
                        and (it + 1) > int(spec.harvest_burn * n_iters)
                        and (it + 1) % spec.harvest_every == 0):
                    g = sampler.to_canonical_global(gs)  # every rank gathers
                    if b is not None:
                        b.add_state(g, it=it + 1)
                need_eval = (it + 1) % spec.eval_every == 0 or last
                need_ckpt = (it + 1) % spec.ckpt_every == 0 or last
                # reading gs.overflow waits for the whole iteration on the
                # device (and under the mesh gathers the chains'), so it is
                # checked at a bounded cadence only
                overflowed = (
                    need_eval or need_ckpt
                    or (it + 1) % spec.overflow_every == 0
                ) and self._read_overflow(gs) > 0
                if need_eval:
                    rec = self.evaluate(gs, ss, it + 1,
                                        time.perf_counter() - t0)
                    self.history.append(rec)
                    if on_eval:
                        on_eval(rec)
                if need_ckpt or overflowed:
                    self._save(gs, ss, it + 1)
                # adaptive K_tail rides the checkpoint boundary, where tails
                # are empty; the checkpoint just written stays valid (tails
                # are not serialized)
                if (need_ckpt and spec.k_tail_grow > 0 and not last
                        and not overflowed):
                    gs, ss, grew = self._maybe_grow_tail(gs, ss)
                    if grew:
                        spec, sampler = self.spec, self.sampler
                if overflowed:
                    raise RuntimeError(
                        f"K_max={spec.K_max} overflow at it={it}; restart "
                        f"with 2x K_max"
                    )
        return sampler.to_canonical_global(gs), sampler.to_canonical(ss)

    def _read_overflow(self, gs: HybridGlobal) -> int:
        """Promoted features dropped for lack of a K_max slot (the most of
        any chain): a host read."""
        with tracing.transfer("overflow"):
            return int(self.sampler.over_chains(
                gs.overflow.reshape(-1)).max())

    # ---- diagnostics ------------------------------------------------------
    def _record_trace(self, gs: HybridGlobal) -> None:
        # device rows of shape (C,) (chainless: (1,)): converting here
        # would wait on every iteration
        self.trace["sigma_x"].append(gs.sigma_x.reshape(-1))
        self.trace["K"].append(torch.sum(gs.active, dim=-1).reshape(-1))

    def diagnostics(self, burn_frac: float = 0.5) -> dict[str, float]:
        """split-R-hat / ESS / MCSE of the monitored scalars over the
        post-burn tail of the per-iteration trace. R-hat is NaN until the
        trace has enough post-burn draws. Under the mesh the chains'
        traces are gathered (a collective of every rank)."""
        out: dict[str, float] = {}
        for name, rows in self.trace.items():
            for i, r in enumerate(rows):
                if not isinstance(r, np.ndarray):
                    with tracing.transfer("trace"):
                        rows[i] = r.cpu().numpy().astype(np.float64)
            if len(rows) < 8:
                continue
            arr = self.sampler.over_chains(
                torch.from_numpy(np.stack(rows, axis=1))).numpy()  # (C, T)
            tail = arr[:, int(burn_frac * arr.shape[1]):]
            s = convergence.summarize(tail, name)
            for k in ("rhat", "ess", "mcse"):
                out[f"{name}_{k}"] = s[f"{name}_{k}"]
        return out

    def evaluate(self, gs: HybridGlobal, ss: HybridShard, it: int,
                 elapsed: float) -> dict[str, Any]:
        with tracing.span("eval"):
            # this rank's rows under data="shardmap", else all N
            X = self.sampler.Xs.reshape(-1, self.sampler.D)
            if self.spec.chain_axis:
                return self._evaluate_chains(X, gs, ss, it, elapsed)
            ll = self.sampler.sum_over_data(train_joint_loglik(
                X, ss.Z.reshape(X.shape[0], -1), gs.A, gs.pi, gs.active,
                gs.sigma_x))
            with tracing.transfer("eval", 5):
                rec: dict[str, Any] = {
                    "it": it,
                    "t": elapsed,
                    "K": int(torch.sum(gs.active)),
                    "alpha": float(gs.alpha),
                    "sigma_x": float(gs.sigma_x),
                    "joint_ll_train": float(ll),
                    "K_tail": int(self.spec.K_tail),
                    "tail_sat": int(gs.tail_sat),
                }
            if self.X_eval is not None:
                ll_eval = heldout_joint_loglik(
                    self.X_eval, gs.A, gs.pi, gs.active, gs.sigma_x,
                    prng.fold_in(gs.key, 999))
                with tracing.transfer("eval"):
                    rec["joint_ll_eval"] = float(ll_eval)
            rec.update(self.diagnostics())
            return rec

    def _evaluate_chains(self, X: torch.Tensor, gs: HybridGlobal,
                         ss: HybridShard, it: int, elapsed: float
                         ) -> dict[str, Any]:
        """A chain-batched eval record: the means over chains, the
        per-chain lists, and each chain's held-out log-likelihood under
        ``fold_in(key_c, 999)`` (the record keeps their mean). Under the
        mesh a rank computes its own chain's values only: the train
        log-likelihood summed over its data ranks, the held-out one on
        its replicated master; the chains' values and HybridGlobals are
        gathered over the chain axis."""
        s = self.sampler
        ev = None
        if s.chain is None:  # every chain on this device, all N rows
            lls = torch.stack([train_joint_loglik(
                X, ss.Z[c].reshape(self.N, -1), gs.A[c], gs.pi[c],
                gs.active[c], gs.sigma_x[c]) for c in range(ss.Z.shape[0])])
            if self.X_eval is not None:
                ev = torch.stack([heldout_joint_loglik(
                    self.X_eval, gs.A[c], gs.pi[c], gs.active[c],
                    gs.sigma_x[c], prng.fold_in(gs.key[c], 999))
                    for c in range(gs.A.shape[0])])
        else:  # chain c, this rank's rows
            lls = s.over_chains(s.sum_over_data(train_joint_loglik(
                X, ss.Z.reshape(X.shape[0], -1), gs.A, gs.pi, gs.active,
                gs.sigma_x)).reshape(1))
            if self.X_eval is not None:
                ev = s.over_chains(heldout_joint_loglik(
                    self.X_eval, gs.A, gs.pi, gs.active, gs.sigma_x,
                    prng.fold_in(gs.key, 999)).reshape(1))
            gs = s.to_canonical_global(gs)
        with tracing.transfer("eval", 5):
            lls = lls.cpu().numpy()
            Ks = torch.sum(gs.active, dim=-1).cpu().numpy()
            sx = gs.sigma_x.cpu().numpy()
            sat = gs.tail_sat.cpu().numpy()
            alpha = float(gs.alpha.mean())
        rec: dict[str, Any] = {
            "it": it,
            "t": elapsed,
            "K": float(Ks.mean()),
            "K_chains": [int(k) for k in Ks],
            "alpha": alpha,
            "sigma_x": float(sx.mean()),
            "sigma_x_chains": [float(v) for v in sx],
            "joint_ll_train": float(lls.mean()),
            "joint_ll_train_chains": [float(v) for v in lls],
            "K_tail": int(self.spec.K_tail),
            "tail_sat": int(sat.max()),
            "tail_sat_chains": [int(v) for v in sat],
        }
        if ev is not None:
            with tracing.transfer("eval"):
                rec["joint_ll_eval"] = float(ev.mean())
        rec.update(self.diagnostics())
        return rec
