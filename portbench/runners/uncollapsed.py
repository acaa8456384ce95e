"""The serial uncollapsed baseline: ``uncollapsed_step`` in a loop.

Set-up makes the data on the device from the seed, the initial state
(``init_state`` from the seed's key) and warms the step's kernels with
a few steps, which it then drops: the window starts again from the
initial state. The window reads the state to the host (σ_x) every
``read_every`` steps and ends at the first read after ``--seconds``.
"""
from __future__ import annotations

import torch

from .. import check, data, devtrace, keys, work
from ..harness import Ctx, Outcome, cuda_sync, now, peak_bytes


def _state(st) -> dict:
    return dict(Z=st.Z, A=st.A, pi=st.pi, active=st.active,
                sigma_x=st.sigma_x, sigma_a=st.sigma_a, alpha=st.alpha,
                key=keys.word(st.key), it=int(st.it))


def run(ctx: Ctx) -> Outcome:
    from repro_torch import prng
    from repro_torch.core.ibp import IBPHypers
    from repro_torch.core.ibp import uncollapsed as unc
    from repro_torch.core.ibp.state import init_state

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    s = cfg["sampler"]
    X = data.rows(cfg, ctx.seed, cfg["N"], dev)
    hyp = IBPHypers(**cfg["hypers"])
    step = unc.uncollapsed_step
    if ctx.fault is not None:
        step = ctx.fault(step)

    def start():
        return init_state(prng.key(ctx.seed), cfg["N"], cfg["D"],
                          s["K_max"], K_init=tr["K_init"], device=dev)

    st = start()
    for _ in range(tr["warm_iters"]):
        st = step(st, X, hyp)
    float(st.sigma_x)
    st = start()
    cuda_sync(dev)
    seconds = min(ctx.seconds, tr["trace_seconds"]) if ctx.trace \
        else ctx.seconds
    setup_s = now() - ctx.t_start
    steps, prev = 0, None
    with devtrace.traced(ctx.trace) as prof:
        t0 = now()
        while True:
            prev, st = st, step(st, X, hyp)
            steps += 1
            if steps % tr["read_every"] == 0:
                float(st.sigma_x)
                if now() - t0 >= seconds:
                    break
        cuda_sync(dev)
        window_s = now() - t0
    peak = peak_bytes(dev)
    trace = devtrace.summarize(prof, window_s)
    del prof
    pre, post = _state(prev), _state(st)
    del prev, st
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    X = data.rows(cfg, ctx.seed, cfg["N"], dev)
    numbers = check.uncollapsed_numbers(pre, post, X, cfg["hypers"])
    control = None
    if ctx.control:
        side = check.uncollapsed_control(pre, post, X, cfg["hypers"])
        control = check.uncollapsed_numbers(pre, side, X, cfg["hypers"],
                                            control=True)
    facts = dict(kind="uncollapsed", iters=steps, window_s=window_s,
                 k_live=float(s["K_max"]),
                 launches=work.uncollapsed_launches(cfg["N"], s["K_max"],
                                                    cfg["D"]),
                 trace=trace, control=control)
    return Outcome(e2e={"step_s": window_s / steps, "setup_s": setup_s},
                   numbers=numbers, facts=facts, attempted=steps, failed=0,
                   memory_peak_bytes=peak, trace=trace)
