"""The hybrid sampler through the CLI's path: ``MCMCDriver.run``.

Set-up makes the data on the device from the seed, builds the driver
(``launch/mcmc.py``'s construction: a ``SamplerSpec`` for the traffic's
driver and tail, a fresh checkpoint directory under ``TMPDIR``), and
warms every kernel and shape: a few iterations from the seed's initial
state and one eval. The window is one ``MCMCDriver.run`` from that same
initial state; its ``on_eval`` ends the window at the first eval record
after ``--seconds`` (eval records end in host reads, so the window ends
with the device idle). No checkpoint is due inside it.

The driver's sampler is wrapped so that the harness keeps the state
before and after the last iteration (references, no copies); after the
window the reference follows that iteration stage by stage.

The stages are watched through two public functions of the program,
which the iteration module looks up by name and which the harness
wraps for the run: ``uncollapsed_sweep`` (``core/ibp/sweeps.py``: X, Z
and the sweep's parameters in, a new Z out) and ``collapsed_row_scan``
(``core/ibp/collapsed.py``: the tail's Z and live mask in, the scanned
ones out). They are the interface the benchmark keeps with
``core/ibp/hybrid.py``: an iteration that no longer calls them there
records no stage and reads ``stage_chain`` infinite. Whatever they
record is tied to the iteration's public input and output
(``check.stage_chain``), so a stage whose result the iteration drops
does not pass.
"""
from __future__ import annotations

import shutil
import tempfile

import torch

from .. import check, data, devtrace, work
from ..harness import Ctx, Outcome, cuda_sync, now, peak_bytes


class WindowClosed(Exception):
    pass


class _Recorder:
    """The driver's sampler, keeping references to the last step's input
    and output, each of its sweeps' (Z in, Z out) and each of its tail
    scans' (tail in, tail out, live mask out) of the one chain. The
    stages are watched through the iteration module's names of the two
    public functions (module docstring), put back by ``close``."""

    def __init__(self, sampler, hybrid_module):
        self._s = sampler
        self._mod = hybrid_module
        self._sweep = hybrid_module.uncollapsed_sweep
        self._scan = hybrid_module.collapsed_row_scan
        hybrid_module.uncollapsed_sweep = self._watch_sweep
        hybrid_module.collapsed_row_scan = self._watch_scan
        self.sweeps: list = []
        self.tails: list = []
        self.last = None

    def __getattr__(self, name):
        return getattr(self._s, name)

    def _watch_sweep(self, X, Z, *args):
        out = self._sweep(X, Z, *args)
        self.sweeps.append((Z, out))
        return out

    def _watch_scan(self, Z, active, *args, **kw):
        out = self._scan(Z, active, *args, **kw)
        self.tails.append((Z[0], out[0][0], out[1][0]))
        return out

    def step(self, gs, ss):
        self.sweeps, self.tails = [], []
        out = self._s.step(gs, ss)
        self.last = (gs, ss, out, self.sweeps, self.tails)
        return out

    def close(self):
        self._mod.uncollapsed_sweep = self._sweep
        self._mod.collapsed_row_scan = self._scan


def _state(gs, ss) -> dict:
    from .. import keys
    N = ss.Z.shape[0] * ss.Z.shape[1]
    pp = int(gs.p_prime)
    return dict(Z=ss.Z.reshape(N, -1), Z_tail=ss.Z_tail[pp], A=gs.A,
                pi=gs.pi, active=gs.active,
                sigma_x=gs.sigma_x, sigma_a=gs.sigma_a, alpha=gs.alpha,
                key=keys.word(gs.key), p_prime=pp,
                it=int(gs.it))


def run(ctx: Ctx) -> Outcome:
    from repro_torch import prng
    from repro_torch.core.ibp import IBPHypers, SamplerSpec
    from repro_torch.core.ibp import hybrid as hybrid_module
    from repro_torch.runtime import MCMCDriver

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    s = cfg["sampler"]
    X, Xe = data.train_eval(cfg, ctx.seed, dev)
    X_np, Xe_np = X.cpu().numpy(), Xe.cpu().numpy()
    del X, Xe
    ckpt = tempfile.mkdtemp(prefix="portbench-ckpt-")
    rec = None
    try:
        spec = SamplerSpec.for_driver(
            tr["driver"], P=s["P"], K_max=s["K_max"], K_tail=s["K_tail"],
            L=s["L"], n_iters=10**9, eval_every=tr["eval_every"],
            ckpt_every=10**9, ckpt_dir=ckpt, seed=ctx.seed,
            collapsed_backend=tr["collapsed_backend"])
        hyp = IBPHypers(**cfg["hypers"])
        drv = MCMCDriver(X_np, spec, hyp, X_eval=Xe_np, device=dev)
        rec = _Recorder(drv.sampler, hybrid_module)
        drv.sampler = rec
        if ctx.fault is not None:
            ctx.fault(rec)
        gs, ss = rec.init(prng.key(ctx.seed))
        for _ in range(tr["warm_iters"]):
            gs, ss = rec.step(gs, ss)
        drv.evaluate(gs, ss, 0, 0.0)
        del gs, ss
        rec.last = None
        cuda_sync(dev)
        seconds = min(ctx.seconds, tr["trace_seconds"]) if ctx.trace \
            else ctx.seconds
        records = []
        setup_s = now() - ctx.t_start
        with devtrace.traced(ctx.trace) as prof:
            t0 = now()

            def on_eval(r):
                records.append(r)
                if now() - t0 >= seconds:
                    raise WindowClosed

            try:
                drv.run(on_eval=on_eval)
            except WindowClosed:
                pass
            cuda_sync(dev)
            window_s = now() - t0
        peak = peak_bytes(dev)
        trace = devtrace.summarize(prof, window_s)
        del prof
        iters = records[-1]["it"]
        gs0, ss0, (gs1, ss1), sweeps, tails = rec.last
        rec.last = None
        pre, post = _state(gs0, ss0), _state(gs1, ss1)
        post["ll_train"] = records[-1]["joint_ll_train"]
        post["ll_eval"] = records[-1]["joint_ll_eval"]
        k_live = sum(r["K"] for r in records) / len(records)
        del drv, gs0, ss0, gs1, ss1
    finally:
        if rec is not None:
            rec.close()
        shutil.rmtree(ckpt, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # the reference: the data again from the seed, the last iteration
    # followed from the state before it
    X, Xe = data.train_eval(cfg, ctx.seed, dev)
    numbers = check.hybrid_numbers(pre, post, X, Xe, cfg["hypers"], s["P"],
                                   s["L"], sweeps, tails)
    control = None
    if ctx.control:
        side = check.hybrid_control(pre, post, X, Xe, cfg["hypers"], s["P"])
        control = check.hybrid_numbers(pre, side, X, Xe, cfg["hypers"],
                                       s["P"], s["L"], sweeps, tails,
                                       control=True)
    del sweeps, tails
    launches = work.hybrid_launches(
        cfg["N"], s["K_max"], s["K_tail"], cfg["D"], s["P"], s["L"],
        k_live, 0.0, cfg["N_eval"], tr["eval_every"])
    facts = dict(kind="hybrid", iters=iters, evals=len(records),
                 window_s=window_s, k_live=k_live, launches=launches,
                 trace=trace, control=control)
    return Outcome(e2e={"iter_s": window_s / iters, "setup_s": setup_s},
                   numbers=numbers, facts=facts, attempted=iters, failed=0,
                   memory_peak_bytes=peak, trace=trace)
