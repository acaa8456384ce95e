"""Shared arithmetic of the per-layer readers in ``metrics/``.

Each reader takes the run's facts (``Outcome.facts``: the traced
window's summary under ``trace``, the runner's counts) and returns a
number, or ``None`` where the record holds nothing to read; the harness
then leaves the metric out. A share of a roofline or a peak is never
made up: where the profiler saw none of a kernel's launches, its
roofline is ``None``.
"""
from __future__ import annotations

from . import devtrace, work

# the port's kernels by the names of their device functions
KERNEL_PARTS = {
    "gibbs_flip": ("gibbs_flip", "gibbs_gram"),
    "collapsed_scan": ("collapsed_scan",),
    "feature_stats": ("feature_stats",),
    "gaussian_sse": ("sse_mma", "sse_final"),
}


def kernel_s(facts: dict, kernel: str) -> float | None:
    t = facts.get("trace")
    return None if t is None else devtrace.seconds_of(t, *KERNEL_PARTS[kernel])


def per_iter_ms(facts: dict, kernel: str) -> float | None:
    s = kernel_s(facts, kernel)
    return None if s is None else 1e3 * s / facts["iters"]


def roofline(facts: dict, kernel: str) -> float | None:
    """The kernel's least time over its device time in the window, %."""
    s = kernel_s(facts, kernel)
    runs = facts.get("launches", {}).get(kernel)
    if s is None or not runs or s <= 0:
        return None
    return 100.0 * facts["iters"] * work.least_of(runs) / s


def mfu(facts: dict) -> float | None:
    """The iterations' summed least kernel times over the window, %."""
    if facts.get("trace") is None:
        return None
    least = sum(work.least_of(r) for r in facts["launches"].values())
    return 100.0 * facts["iters"] * least / facts["window_s"]


def idle(facts: dict) -> float | None:
    t = facts.get("trace")
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
