"""The program's own record of a traced window, on the profiler's clock.

While ``torch.profiler`` records, the program (``repro_torch.tracing``)
records its spans (a pass through a layer: ``driver``, ``iteration``,
``sweep``, ``tail``, ``sync``, ``eval``), its host transfers (counters
``host_transfers.<site>`` and each transfer block's interval) and a
re-run of the window's last tail. ``record(facts)`` hands that record to
the readers in ``metrics/``; a program without ``repro_torch.tracing``
records nothing, and its readers then report nothing.

``host_ms`` is a span's host time less the host transfers inside it,
where the host waits for the device. ``scan_cycles`` runs the kept tail
again under ``tracing.recording()``, after the window and untimed: only
there does the scan launch its traced instance, whose row phases'
cycles it reads. ``summarize(prof, rec)`` splits the window's device
idle time exactly: each idle instant goes to the innermost span open
then (that span's self time), and what no span covers is kept apart, so
the parts and the uncovered rest add up to the idle time. The device's
busy intervals are ``devtrace``'s: every device operation, copies
included, unioned. Spans are stamped on the clock Kineto stamps its
events with (Unix ns), so they are placed on the profiler's timeline by
its ``trace_start_ns``. ``launches_in_spans`` checks that alignment on
the card: a kernel starts after the span that launched it opened.
"""
from __future__ import annotations

import bisect

import torch

from . import devtrace


def record(facts: dict):
    """The program's record of the traced window, or None: no traced
    window, or no record kept by the program."""
    if facts.get("trace") is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.profiled()


def host_ms(facts: dict, name: str) -> float | None:
    """Mean host ms of a ``name`` span less the host transfers inside
    it; None where no such span was recorded."""
    rec = record(facts)
    if rec is None:
        return None
    waits = sorted((a, b) for _, a, b in rec.waits)
    starts = [a for a, _ in waits]
    out = []
    for n, a, b, _ in rec.spans:
        if n != name:
            continue
        i, w = bisect.bisect_left(starts, a), 0
        while i < len(waits) and waits[i][0] < b:
            w += min(waits[i][1], b) - waits[i][0]
            i += 1
        out.append(b - a - w)
    return 1e-6 * sum(out) / len(out) if out else None


def scan_cycles(facts: dict, phase: str) -> float | None:
    """Cycles a row of the tail scan's ``phase`` (``tracing.SCAN_FIELDS``)
    in the window's last tail, run again under ``tracing.recording()``;
    None where no tail was kept or its scan has no traced instance."""
    rec = record(facts)
    rep = None if rec is None else rec.replayed("tail")
    if rep is None or not rep.scan["rows"]:
        return None
    return rep.scan[phase] / rep.scan["rows"]


def self_intervals(spans) -> list[tuple[float, float, str]]:
    """Each span's interval less its children's, as (start, end, name),
    sorted: the spans' self times, which partition what they cover.
    ``spans`` as the record keeps them: [name, start, end, parent], a
    parent listed before its children."""
    kids: dict[int, list[int]] = {}
    for i, s in enumerate(spans):
        kids.setdefault(s[3], []).append(i)
    out = []
    for i, (name, a, b, _) in enumerate(spans):
        cur = a
        for k in kids.get(i, ()):
            ka, kb = spans[k][1], spans[k][2]
            if ka > cur:
                out.append((cur, ka, name))
            cur = max(cur, kb)
        if b > cur:
            out.append((cur, b, name))
    return sorted(out)


def idle_by_span(busy, spans, lo: float, hi: float
                 ) -> tuple[float, dict[str, float], float]:
    """(idle time in [lo, hi], idle time under each span name's self
    time, the idle time no span covers), in the units of the arguments.
    ``busy``: the device's busy intervals, sorted and disjoint
    (``devtrace._union``)."""
    idle, cur = [], lo
    for a, b in busy:
        if a > cur:
            idle.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        idle.append((cur, hi))
    idle = [(a, b) for a, b in idle if b > a]
    total = sum(b - a for a, b in idle)
    by: dict[str, float] = {}
    selves = self_intervals(spans)
    i = j = 0
    while i < len(idle) and j < len(selves):
        a = max(idle[i][0], selves[j][0])
        b = min(idle[i][1], selves[j][1])
        if b > a:
            by[selves[j][2]] = by.get(selves[j][2], 0.0) + (b - a)
        if idle[i][1] < selves[j][1]:
            i += 1
        else:
            j += 1
    return total, by, total - sum(by.values())


def summarize(prof, rec) -> dict | None:
    """The traced window's idle time split by the program's spans, in
    ms: ``idle_ms`` in all (from the first to the last event or span),
    ``by_span`` under each span name's self time, ``uncovered_ms``."""
    if prof is None or rec is None or not rec.spans:
        return None
    t0 = prof.profiler.kineto_results.trace_start_ns()
    dev, ends = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        ends += (a, b)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((a, b))
    spans = [[n, (a - t0) / 1e3, (b - t0) / 1e3, p]
             for n, a, b, p in rec.spans]
    ends += [s[1] for s in spans] + [s[2] for s in spans]
    total, by, rest = idle_by_span(devtrace._union(dev), spans, min(ends),
                                   max(ends))
    return {"idle_ms": total / 1e3,
            "by_span": {n: v / 1e3 for n, v in sorted(by.items())},
            "uncovered_ms": rest / 1e3}


def _innermost(spans, t):
    """The innermost span (by the record's nesting) open at ``t``, or
    None; ``spans`` sorted by start."""
    inner = None
    for s in spans:
        if s[1] > t:
            break
        if t <= s[2]:
            inner = s
    return inner


def launches_in_spans(prof, rec, part: str, layers: tuple[str, ...]
                      ) -> dict:
    """For each device kernel whose name holds ``part``: the innermost
    span open when its launch call ran (the runtime call that shares its
    correlation id). Counts the kernels, those launched under one of
    ``layers`` that started no earlier than that span opened, and those
    whose launch call was not found."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.profiler.kineto_results.events()
    calls = {e.correlation_id(): e.start_ns() for e in evs
             if e.device_type() != cuda and e.name().startswith("cuda")}
    spans = sorted(rec.spans, key=lambda s: s[1])
    n = ok = lost = 0
    for e in evs:
        if e.device_type() != cuda or part not in e.name():
            continue
        n += 1
        t = calls.get(e.correlation_id())
        if t is None:
            lost += 1
            continue
        inner = _innermost(spans, t)
        if (inner is not None and inner[0] in layers
                and e.start_ns() >= inner[1]):
            ok += 1
    return {"kernels": n, "in_their_spans": ok, "launch_not_found": lost}


def syncs_in_spans(prof, rec) -> dict[str, int]:
    """The runtime calls that wait for the device (``devtrace.SYNC_CALLS``)
    by the innermost span open when each ran and the operation that made
    it: ``"<span> / <op>"`` -> count."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    spans = sorted(([n, (a - t0) / 1e3, (b - t0) / 1e3, p]
                    for n, a, b, p in rec.spans), key=lambda s: s[1])
    out: dict[str, int] = {}
    for e in prof.events():
        if e.name not in devtrace.SYNC_CALLS:
            continue
        inner = _innermost(spans, e.time_range.start)
        op = e.cpu_parent.name if e.cpu_parent is not None else "-"
        key = f"{inner[0] if inner else '(no span)'} / {op}"
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))
