"""The program's spans and counters, on the profiler's clock.

``span(name)`` marks one pass through a layer: its name, start, end and
the span that encloses it. ``transfer(site, n)`` marks a block that
moves ``n`` values between host and device: it adds them to the counter
``host_transfers.<site>`` and keeps the block's interval, the host's
wait on the device. ``replay(name, fn)``
keeps a stage's re-run (``fn``, on the inputs it just ran on) for a
reader to run later under its own recording. Nothing is recorded unless
a record is open:

* ``recording()`` opens one for its block and yields it. Inside it
  alone, the hybrid tail's scan runs its traced instance, which adds the
  cycles of its row phases to the record's device buffer
  (``scan_buffer``), read once when the record closes.
* While ``torch.profiler`` records, the program records its spans,
  counters, transfers and replays too, into a record that ``profiled()``
  closes and hands over. A profiler that starts after the program saw
  none running, or after ``profiled()``, gets a new record. No launch
  runs the traced scan instance because a profiler is on, so a profiled
  kernel is the one an unprofiled run launches; the scan's phases are
  read by replaying a kept tail under ``recording()``, untimed.

With no record open, ``span`` and ``transfer`` return one shared no-op
object and ``replay`` returns at once: none allocates,
touches the device or waits for it.

Spans are stamped with ``time.time_ns()``, the Unix clock on which
Kineto stamps the profiler's host and device events (its result's
``trace_start_ns()`` is a reading of the same clock), so spans line up
with the kernels they launch. No profiler event is made for a span: a
``record_function`` range that launches kernels comes back as a
device-side annotation, which a reader of device time would count as
work.

Span names are the layers: ``driver`` (a pass of ``MCMCDriver.run``'s
loop), ``iteration``, ``sweep``, ``tail``, ``sync`` and ``eval``.
Transfer sites: ``init``, ``sigma_x_shape``, ``sigma_shapes``,
``overflow``, ``tail_sat``, ``eval`` and ``trace`` (counted on any
device). Replays: ``tail`` (the last sub-iteration's tail).
"""
from __future__ import annotations

import contextlib
import time

import torch

# the scan's buffer, a row a chain: cycles of each row phase and of the
# whole launch, as the kernel's thread 0 reads clock64(), and the rows
# the launch entered
SCAN_FIELDS = ("move", "refresh", "flip", "birth", "total", "rows")


class Record:
    """What was recorded: ``spans`` as [name, start_ns, end_ns, parent]
    (parent: the enclosing span's index, -1 for none), ``counters`` by
    name, ``waits`` as [site, start_ns, end_ns] (the ``transfer``
    blocks), ``replays`` by name, and after ``close`` the traced scan's
    cycles by phase and rows entered (``scan``, by ``SCAN_FIELDS``,
    summed over chains and launches)."""

    def __init__(self):
        self.spans: list[list] = []
        self.counters: dict[str, int] = {}
        self.waits: list[list] = []
        self.replays: dict = {}
        self.scan = dict.fromkeys(SCAN_FIELDS, 0)
        self.closed = False
        self._open: list[int] = []
        self._bufs: dict[torch.device, torch.Tensor] = {}
        self._replayed: dict[str, Record] = {}

    def close(self) -> None:
        """Read the scan's buffers into ``scan``: one host read a
        device."""
        for buf in self._bufs.values():
            for field, v in zip(SCAN_FIELDS, buf.sum(0).tolist()):
                self.scan[field] += v
        self._bufs.clear()
        self.closed = True

    def replayed(self, name: str) -> Record | None:
        """The kept stage ``name`` run again inside a ``recording()`` of
        its own, once (later calls return the same record); None where
        none was kept."""
        if name not in self._replayed:
            fn = self.replays.get(name)
            if fn is None:
                return None
            with recording() as rec:
                fn()
            self._replayed[name] = rec
        return self._replayed[name]


class _Span:
    __slots__ = ("_rec", "_name", "_i")

    def __init__(self, rec: Record, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        self._i = len(rec.spans)
        rec.spans.append([self._name, time.time_ns(), 0,
                          rec._open[-1] if rec._open else -1])
        rec._open.append(self._i)

    def __exit__(self, *exc):
        self._rec.spans[self._i][2] = time.time_ns()
        self._rec._open.pop()


class _Wait:
    __slots__ = ("_rec", "_site", "_t")

    def __init__(self, rec: Record, site: str):
        self._rec, self._site = rec, site

    def __enter__(self):
        self._t = time.time_ns()

    def __exit__(self, *exc):
        self._rec.waits.append([self._site, self._t, time.time_ns()])


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()
_explicit: Record | None = None  # recording()'s
_profiled: Record | None = None  # kept while torch.profiler records
_profiler_seen_off = True  # the program ran with no profiler since then


def _current() -> Record | None:
    global _profiled, _profiler_seen_off
    if _explicit is not None:
        return _explicit
    if not torch.autograd._profiler_enabled():
        _profiler_seen_off = True
        return None
    if _profiler_seen_off or _profiled is None or _profiled.closed:
        _profiled, _profiler_seen_off = Record(), False
    return _profiled


def span(name: str):
    """A context manager marking one pass through layer ``name``."""
    rec = _current()
    return _OFF if rec is None else _Span(rec, name)


def transfer(site: str, n: int = 1):
    """A context manager around a block that moves ``n`` values between
    host and device at ``site``: counted under ``host_transfers.<site>``,
    its interval kept in ``waits``."""
    rec = _current()
    if rec is None:
        return _OFF
    name = f"host_transfers.{site}"
    rec.counters[name] = rec.counters.get(name, 0) + n
    return _Wait(rec, site)


def replay(name: str, fn) -> None:
    """Keep ``fn``, a call that runs stage ``name`` again on the inputs
    it just ran on and changes nothing, in the open record (the last
    one kept under a name wins)."""
    rec = _current()
    if rec is not None:
        rec.replays[name] = fn


def scan_buffer(device: torch.device, chains: int) -> torch.Tensor | None:
    """Inside ``recording()``: its int64 (≥ chains, len(SCAN_FIELDS))
    buffer on ``device`` for the traced scan; else None. A launch adds to
    rows 0..chains-1."""
    rec = _explicit
    if rec is None:
        return None
    buf = rec._bufs.get(device)
    if buf is None or buf.shape[0] < chains:
        grown = torch.zeros((chains, len(SCAN_FIELDS)), dtype=torch.int64,
                            device=device)
        if buf is not None:
            grown[:buf.shape[0]] += buf
        rec._bufs[device] = buf = grown
    return buf


@contextlib.contextmanager
def recording():
    """Record spans and counters over the block; yields the Record,
    closed at exit. Recordings do not nest."""
    global _explicit
    if _explicit is not None:
        raise RuntimeError("tracing.recording() is already open")
    rec = _explicit = Record()
    try:
        yield rec
    finally:
        _explicit = None
        rec.close()


def profiled() -> Record | None:
    """The record kept while ``torch.profiler`` last recorded, closed;
    None if nothing was recorded under a profiler."""
    if _profiled is not None and not _profiled.closed:
        _profiled.close()
    return _profiled
