"""MCMC driver: run loop, checkpoint/restart, overflow detection, eval
records — over a ``Sampler`` built by ``build_sampler``.

Port of ``repro/runtime/driver.py`` for the single-device layout:

* every ``ckpt_every`` iterations the full sampler state (global params,
  Z in global (N, K) layout, the PRNG key) is written atomically in the
  reference's npz layout; a restart resumes bitwise on the same device.
* overflow (a promoted tail feature dropped for lack of a free K_max slot,
  ``gs.overflow``) is checked every ``overflow_every`` iterations; the
  driver then checkpoints and raises, asking for a restart with a larger
  K_max. Restoring into another K_max (grow/shrink) and adaptive K_tail
  come with a later slice (ROADMAP queue 1 item 6).
* eval records hold K, alpha, sigma_x, the train and held-out joint
  log-likelihoods, K_tail, tail_sat and split-R-hat / ESS / MCSE of the
  per-iteration sigma_x and K+ traces.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import restore, save_pytree
from repro_torch.core.ibp import convergence
from repro_torch.core.ibp.api import SamplerSpec, build_sampler
from repro_torch.core.ibp.hybrid import HybridGlobal, HybridShard
from repro_torch.core.ibp.predict import (
    heldout_joint_loglik,
    train_joint_loglik,
)
from repro_torch.core.ibp.state import IBPHypers


class MCMCDriver:
    """Runs a built Sampler with checkpoint/restart."""

    def __init__(self, X: np.ndarray, spec: SamplerSpec,
                 hyp: IBPHypers | None = None,
                 X_eval: np.ndarray | None = None,
                 device: str | torch.device | None = None):
        self.spec = spec
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

    # ---- state <-> checkpoint layout (global Z) --------------------------
    def _to_ckpt(self, gs: HybridGlobal, ss: HybridShard) -> dict:
        # tail buffers are not serialized: checkpoints are written
        # post-sync, where tails are always cleared
        P, N_p, K = ss.Z.shape
        return {"gs": gs, "Z_global": ss.Z.reshape(P * N_p, K),
                "meta": {"it": gs.it}}

    def _from_ckpt(self, blob: dict) -> tuple[HybridGlobal, HybridShard]:
        spec = self.spec
        gs: HybridGlobal = blob["gs"]
        Zg = blob["Z_global"]
        N, K = Zg.shape
        if K != spec.K_max:
            raise NotImplementedError(
                f"checkpoint in {spec.ckpt_dir} has K_max={K}, this driver "
                f"K_max={spec.K_max}: restoring into another capacity "
                f"(grow/shrink restarts) comes with ROADMAP queue 1 item 6"
            )
        if N != self.N:
            raise ValueError(
                f"checkpoint has N={N} observations but this driver "
                f"truncated the data to N={self.N} (P={spec.P}); pick a P "
                f"that keeps N={N}"
            )
        P = spec.P
        z = torch.zeros((P, N // P, spec.K_tail), dtype=Zg.dtype,
                        device=Zg.device)
        return gs, HybridShard(Z=Zg.reshape(P, N // P, K), Z_tail=z,
                               tail_active=z[:, 0, :].clone())

    def _template(self):
        gs, ss = self.sampler.init()
        return self._to_ckpt(gs, ss)

    # ---- main loop --------------------------------------------------------
    def run(self, n_iters: int | None = None,
            on_eval: Callable[[dict], None] | None = None,
            crash_at: int | None = None):
        """Main loop. ``crash_at`` raises mid-run (for restart tests)."""
        spec = self.spec
        sampler = self.sampler
        n_iters = n_iters or spec.n_iters
        restored = restore(spec.ckpt_dir, self._template())
        if restored is not None:
            gs, ss = self._from_ckpt(restored[0])
            start = int(restored[1])
        else:
            start = 0
            gs, ss = sampler.init(prng.key(spec.seed))

        t0 = time.time()
        for it in range(start, n_iters):
            if crash_at is not None and it == crash_at:
                raise RuntimeError(f"injected crash at iteration {it}")
            gs, ss = sampler.step(gs, ss)
            self._record_trace(gs)
            last = it == n_iters - 1
            need_eval = (it + 1) % spec.eval_every == 0 or last
            need_ckpt = (it + 1) % spec.ckpt_every == 0 or last
            # reading gs.overflow waits for the whole iteration on the
            # device, so it is checked at a bounded cadence only
            overflowed = (
                need_eval or need_ckpt
                or (it + 1) % spec.overflow_every == 0
            ) and int(gs.overflow) > 0
            if need_eval:
                rec = self.evaluate(gs, ss, it + 1, time.time() - t0)
                self.history.append(rec)
                if on_eval:
                    on_eval(rec)
            if need_ckpt or overflowed:
                save_pytree(spec.ckpt_dir, self._to_ckpt(gs, ss), it + 1)
            if overflowed:
                raise RuntimeError(
                    f"K_max={spec.K_max} overflow at it={it}; restart with "
                    f"2x K_max"
                )
        return gs, sampler.to_canonical(ss)

    # ---- diagnostics ------------------------------------------------------
    def _record_trace(self, gs: HybridGlobal) -> None:
        # device scalars: converting here would wait on every iteration
        self.trace["sigma_x"].append(gs.sigma_x.reshape(1))
        self.trace["K"].append(torch.sum(gs.active).reshape(1))

    def diagnostics(self, burn_frac: float = 0.5) -> dict[str, float]:
        """split-R-hat / ESS / MCSE of the monitored scalars over the
        post-burn tail of the per-iteration trace. R-hat is NaN until the
        trace has enough post-burn draws."""
        out: dict[str, float] = {}
        for name, rows in self.trace.items():
            for i, r in enumerate(rows):
                if not isinstance(r, np.ndarray):
                    rows[i] = r.cpu().numpy().astype(np.float64)
            if len(rows) < 8:
                continue
            arr = np.stack(rows, axis=1)               # (1, T)
            tail = arr[:, int(burn_frac * arr.shape[1]):]
            s = convergence.summarize(tail, name)
            for k in ("rhat", "ess", "mcse"):
                out[f"{name}_{k}"] = s[f"{name}_{k}"]
        return out

    def evaluate(self, gs: HybridGlobal, ss: HybridShard, it: int,
                 elapsed: float) -> dict[str, Any]:
        X = self.sampler.Xs.reshape(self.N, -1)
        Z = ss.Z.reshape(self.N, -1)
        rec: dict[str, Any] = {
            "it": it,
            "t": elapsed,
            "K": int(torch.sum(gs.active)),
            "alpha": float(gs.alpha),
            "sigma_x": float(gs.sigma_x),
            "joint_ll_train": float(train_joint_loglik(
                X, Z, gs.A, gs.pi, gs.active, gs.sigma_x)),
            "K_tail": int(self.spec.K_tail),
            "tail_sat": int(gs.tail_sat),
        }
        if self.X_eval is not None:
            rec["joint_ll_eval"] = float(heldout_joint_loglik(
                self.X_eval, gs.A, gs.pi, gs.active, gs.sigma_x,
                prng.fold_in(gs.key, 999)))
        rec.update(self.diagnostics())
        return rec
