"""The program's spans and counters as the benchmark reads them, on the
CPU: the exact split of a synthetic window's idle time by span (its
parts and the uncovered rest add up to the idle time, spans straddling
a gap take their share of it), and each new reader's value from a
record the program kept under the profiler (host time less the host
transfers inside a span; the kept tail's scan run again under
``recording()``); a program without ``repro_torch.tracing`` gives
none."""
from __future__ import annotations

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from portbench.run import read_metric

harness.port_path()
from repro_torch import tracing  # noqa: E402

NEW = ("iter_host_ms", "iter_host_ms.step", "host_transfers.sample",
       "host_transfers.step", "tail_move_cycles", "tail_refresh_cycles",
       "tail_flip_cycles", "tail_birth_cycles")


def test_self_intervals_partition_nested_spans():
    sp = [["driver", 0, 100, -1], ["iteration", 10, 80, 0],
          ["sweep", 10, 30, 1], ["tail", 40, 70, 1], ["eval", 85, 95, 0]]
    assert spans.self_intervals(sp) == [
        (0, 10, "driver"), (10, 30, "sweep"), (30, 40, "iteration"),
        (40, 70, "tail"), (70, 80, "iteration"), (80, 85, "driver"),
        (85, 95, "eval"), (95, 100, "driver")]


def test_idle_split_is_exact():
    # device busy [5, 20), [25, 50), [60, 90); window [0, 120)
    busy = [(5, 20), (25, 50), (60, 90)]
    sp = [["driver", 0, 100, -1], ["iteration", 10, 80, 0],
          ["sweep", 10, 30, 1], ["tail", 40, 70, 1], ["eval", 85, 95, 0]]
    total, by, rest = spans.idle_by_span(busy, sp, 0, 120)
    # idle: [0, 5) [20, 25) [50, 60) [90, 120)
    assert total == 5 + 5 + 10 + 30
    assert by == {"driver": 5 + 5, "sweep": 5, "tail": 10, "eval": 5}
    assert rest == 20  # [100, 120): no span open
    assert sum(by.values()) + rest == total


def test_spans_straddling_a_gap_share_it():
    # one gap [10, 40); a sweep ends inside it, a tail starts inside it,
    # their parent covers the rest
    busy = [(0, 10), (40, 50)]
    sp = [["iteration", 0, 50, -1], ["sweep", 0, 15, 0],
          ["tail", 32, 50, 0]]
    total, by, rest = spans.idle_by_span(busy, sp, 0, 50)
    assert total == 30
    assert by == {"sweep": 5, "iteration": 17, "tail": 8}
    assert rest == 0
    # a window wider than the spans leaves its ends uncovered
    total, by, rest = spans.idle_by_span(busy, sp, -5, 60)
    assert (total, rest) == (45, 15) and sum(by.values()) == 30


def _scan_of_two_chains():
    """What a traced launch of two chains adds to the recording's buffer:
    cycles by phase, the total, and 4 + 6 rows."""
    buf = tracing.scan_buffer(torch.device("cpu"), 2)
    buf += torch.tensor([[10, 20, 30, 35, 100, 4], [10, 0, 50, 0, 100, 6]])


def _profiled_record():
    """A record kept under the profiler: two iterations of 2 and 4 ms
    that wait 0.5 and 1.5 ms in five host transfers, and a tail kept to
    run again."""
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("iteration"):
            with tracing.transfer("a", 2):
                pass
        with tracing.span("iteration"):
            with tracing.transfer("b", 3):
                pass
        tracing.replay("tail", _scan_of_two_chains)
        # the profiler alone gives no traced scan
        assert tracing.scan_buffer(torch.device("cpu"), 2) is None
    rec = tracing.profiled()
    rec.spans[0][1:3] = [0, 2_000_000]
    rec.spans[1][1:3] = [5_000_000, 9_000_000]
    rec.waits[0][1:3] = [500_000, 1_000_000]
    rec.waits[1][1:3] = [6_000_000, 7_500_000]
    return rec


def test_new_readers_read_the_programs_record():
    rec = _profiled_record()
    assert rec.scan == dict.fromkeys(tracing.SCAN_FIELDS, 0)
    facts = {"trace": {"window_s": 1.0}, "iters": 2}
    want = {"iter_host_ms": 2.0, "iter_host_ms.step": 2.0,
            "host_transfers.sample": 2.5, "host_transfers.step": 2.5,
            "tail_move_cycles": 2.0, "tail_refresh_cycles": 2.0,
            "tail_flip_cycles": 8.0, "tail_birth_cycles": 3.5}
    for name in NEW:
        assert read_metric(name, facts) == pytest.approx(want[name]), name
    # the tail ran again once, under a recording of its own
    assert rec.replayed("tail").scan == {
        "move": 20, "refresh": 20, "flip": 80, "birth": 35, "total": 200,
        "rows": 10}
    # an untraced run reads nothing
    assert all(read_metric(n, {"trace": None, "iters": 2}) is None
               for n in NEW)


def test_a_program_without_tracing_reads_nothing(monkeypatch):
    _profiled_record()
    # the parent commit's program: no repro_torch.tracing to import
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    facts = {"trace": {"window_s": 1.0}, "iters": 2}
    assert all(read_metric(n, facts) is None for n in NEW)


def test_shares_need_a_traced_scan():
    # no tail kept, or a kept tail whose scan has no traced instance (the
    # plain scan on the CPU, another flavor): no cycles to read
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("iteration"):
            pass
    facts = {"trace": {"window_s": 1.0}, "iters": 1}
    assert read_metric("tail_flip_cycles", facts) is None
    assert read_metric("host_transfers.sample", facts) == 0.0
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("iteration"):
            tracing.replay("tail", lambda: None)
    assert read_metric("tail_flip_cycles", facts) is None
    assert read_metric("iter_host_ms", facts) > 0.0
