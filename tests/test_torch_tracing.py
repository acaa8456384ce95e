"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

* Off (no record open, no profiler): ``span`` and ``transfer`` are one
  shared no-op object, ``replay`` returns, and none allocates.
* Spans nest with their parents' indices; transfers add to their
  counters and keep their intervals.
* The shared clock: a span around a torch op encloses the profiler's
  event of that op, once the span is shifted by the profiler's
  ``trace_start_ns``; under the profiler the program records without
  ``recording()``, a record a profiler session, and ``profiled()``
  hands the last one over; the profiler alone never asks for the traced
  scan.
* The layers: a hybrid iteration is one ``iteration`` holding L
  ``sweep``, L ``tail`` and one ``sync``, and keeps its last tail to run
  again; ``uncollapsed_step`` is an ``iteration`` holding a ``sweep``
  and a ``sync``; ``MCMCDriver.run`` a ``driver`` span an iteration,
  with ``eval`` inside, and the host transfers of each site.
* Recording changes no output: the samplers' states are bitwise equal
  with recording on and off.
"""
import tracemalloc

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import prng, tracing
from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
from repro_torch.core.ibp.state import init_state
from repro_torch.core.ibp.uncollapsed import uncollapsed_step
from repro_torch.data import cambridge_data
from repro_torch.runtime import MCMCDriver

torch.set_num_threads(1)


def _X(N=60):
    return cambridge_data(N=N, sigma_n=0.5, seed=3)[0]


def _names(rec, parent):
    return [s[0] for s in rec.spans if s[3] == parent]


def _tree_equal(a, b):
    for k, v in vars(a).items():
        w = getattr(b, k)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), k


def _held_by_tracing():
    """Blocks allocated by tracing.py that a thousand passes through a
    span, a transfer and a replay leave held (other threads' allocations
    excluded)."""
    tracemalloc.start()
    try:
        for _ in range(1000):
            with tracing.span("iteration"):
                with tracing.transfer("x", 2):
                    pass
                tracing.replay("tail", _X)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    snap = snap.filter_traces([tracemalloc.Filter(True, tracing.__file__)])
    return sum(st.count for st in snap.statistics("filename"))


def test_off_records_nothing_and_allocates_nothing():
    assert not torch.autograd._profiler_enabled()
    before = tracing.profiled()
    a, b = tracing.span("driver"), tracing.span("sweep")
    assert a is b and tracing.transfer("x") is a
    with a:
        with tracing.transfer("x"):
            pass
    # blocks allocated in tracing.py and still held after a thousand
    # passes: none while off; a thousand spans' worth while recording
    assert _held_by_tracing() == 0
    with tracing.recording():
        assert _held_by_tracing() >= 1000
    # nothing was opened under the profiler either
    assert tracing.profiled() is before
    assert tracing.scan_buffer(torch.device("cpu"), 1) is None


def test_spans_nest_with_parent_links():
    with tracing.recording() as rec:
        with tracing.span("driver"):
            with tracing.span("iteration"):
                with tracing.span("sweep"):
                    with tracing.transfer("a"):
                        pass
                with tracing.span("tail"):
                    pass
            with tracing.span("eval"):
                with tracing.transfer("a", 3):
                    pass
        with tracing.span("driver"):
            pass
    names = [s[0] for s in rec.spans]
    assert names == ["driver", "iteration", "sweep", "tail", "eval",
                     "driver"]
    assert [s[3] for s in rec.spans] == [-1, 0, 1, 1, 0, -1]
    assert all(s[1] <= s[2] for s in rec.spans)
    # a child lies inside its parent
    for s in rec.spans:
        if s[3] >= 0:
            p = rec.spans[s[3]]
            assert p[1] <= s[1] and s[2] <= p[2]
    assert rec.counters == {"host_transfers.a": 4}
    # a transfer's interval lies inside the span it ran in
    assert [w[0] for w in rec.waits] == ["a", "a"]
    for w, sp in zip(rec.waits, (rec.spans[2], rec.spans[4])):
        assert sp[1] <= w[1] <= w[2] <= sp[2]
    assert rec.closed and rec.scan == dict.fromkeys(tracing.SCAN_FIELDS, 0)
    # closed: nothing more is recorded
    assert tracing.span("driver") is tracing.span("sweep")


def test_span_encloses_its_op_on_the_profilers_clock():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("sweep"):
            torch.mm(a, b)
        with tracing.transfer("x"):
            pass
        # the profiler alone never selects the traced scan instance
        assert tracing.scan_buffer(torch.device("cpu"), 1) is None
    rec = tracing.profiled()
    assert rec is not None and rec.closed
    assert [s[0] for s in rec.spans] == ["sweep"]
    assert rec.counters == {"host_transfers.x": 1}
    t0 = prof.profiler.kineto_results.trace_start_ns()
    name, start, end, _ = rec.spans[0]
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mm) == 1
    assert (start - t0) / 1e3 <= mm[0].time_range.start
    assert mm[0].time_range.end <= (end - t0) / 1e3
    # the profiled record is handed over once; the next profiled stretch
    # opens another
    assert tracing.profiled() is rec
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("tail"):
            pass
    again = tracing.profiled()
    assert again is not rec and [s[0] for s in again.spans] == ["tail"]
    # a profiler started after the program ran without one gets its own
    # record, though nothing handed the last one over
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("sweep"):
            pass
    with tracing.span("sync"):  # no profiler
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("eval"):
            pass
    assert [s[0] for s in tracing.profiled().spans] == ["eval"]


def test_hybrid_iteration_holds_its_stages():
    L = 3
    s = build_sampler(SamplerSpec(P=3, K_max=12, K_tail=4, L=L, seed=2),
                      IBPHypers(), _X(), device="cpu")
    gs, ss = s.init()
    with tracing.recording() as rec:
        s.step(gs, ss)
    it = [i for i, sp in enumerate(rec.spans) if sp[0] == "iteration"]
    assert len(it) == 1 and rec.spans[it[0]][3] == -1
    assert _names(rec, it[0]) == ["sweep", "tail"] * L + ["sync"]
    assert rec.counters == {"host_transfers.sigma_x_shape": 1}
    (site, a, b), = rec.waits
    assert site == "sigma_x_shape"
    assert rec.spans[it[0]][1] <= a <= b <= rec.spans[it[0]][2]
    # the last tail, kept to run again: its inputs are left as they were
    # and its generators made anew, so each run gives the same tail
    first, again = rec.replays["tail"](), rec.replays["tail"]()
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    assert rec.replayed("tail") is rec.replayed("tail")


def test_uncollapsed_step_holds_sweep_and_sync():
    X = torch.from_numpy(_X())
    st = init_state(prng.key(4), X.shape[0], X.shape[1], 10, K_init=4,
                    device="cpu")
    with tracing.recording() as rec:
        uncollapsed_step(st, X, IBPHypers())
    assert [s[0] for s in rec.spans] == ["iteration", "sweep", "sync"]
    assert [s[3] for s in rec.spans] == [-1, 0, 0]
    assert rec.counters == {"host_transfers.sigma_shapes": 2}
    assert [w[0] for w in rec.waits] == ["sigma_shapes"]


def test_driver_spans_and_transfer_sites(tmp_path):
    X = _X()
    spec = SamplerSpec(P=2, K_max=8, K_tail=4, L=2, n_iters=6, eval_every=3,
                       overflow_every=2, ckpt_every=100,
                       ckpt_dir=str(tmp_path), seed=5)
    drv = MCMCDriver(X, spec, X_eval=X[:8], device="cpu")
    with tracing.recording() as rec:
        drv.run()
    names = [s[0] for s in rec.spans]
    drivers = [i for i, n in enumerate(names) if n == "driver"]
    assert len(drivers) == 6
    assert all(rec.spans[i][3] == -1 for i in drivers)
    evals = [sp for sp in rec.spans if sp[0] == "eval"]
    assert len(evals) == 2 and {rec.spans[e[3]][0] for e in evals} == {
        "driver"}
    # the initial state's three scalars, for the restore's template and
    # the start; overflow read at it 2, 3 (eval), 4, 6 (eval,
    # checkpoint); each eval reads 5 scalars and the held-out
    # log-likelihood; the traces convert sigma_x and K of every iteration
    # once
    assert rec.counters == {"host_transfers.init": 6,
                            "host_transfers.sigma_x_shape": 6,
                            "host_transfers.overflow": 4,
                            "host_transfers.eval": 12,
                            "host_transfers.trace": 12}
    t = [r["t"] for r in drv.history]
    assert 0.0 <= t[0] <= t[1]


def test_recording_changes_no_output():
    s = build_sampler(SamplerSpec(P=3, K_max=12, K_tail=4, L=2, seed=7),
                      IBPHypers(), _X(), device="cpu")
    gs, ss = s.init()
    off = s.step(gs, ss)
    with tracing.recording():
        on = s.step(gs, ss)
    for a, b in zip(off, on):
        _tree_equal(a, b)
    X = torch.from_numpy(_X())
    st = init_state(prng.key(4), X.shape[0], X.shape[1], 10, K_init=4,
                    device="cpu")
    off = uncollapsed_step(st, X, IBPHypers())
    with tracing.recording():
        on = uncollapsed_step(st, X, IBPHypers())
    _tree_equal(off, on)
    assert np.isfinite(float(on.sigma_x))
