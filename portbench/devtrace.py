"""What a traced window's ``torch.profiler`` record says.

``summarize`` reduces the record to the facts the per-layer metrics read:
device seconds by kernel name, the busy share (the union of every
device operation's interval, copies included), kernel launches, the
CUDA runtime calls that wait for the device, and the longest idle gaps
labelled by the host operation running in them. A record with no device
operation gives ``None``: the metrics that need it report nothing.
"""
from __future__ import annotations

import bisect
import contextlib

import torch

# runtime calls that block the host until the device (or a copy) is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


@contextlib.contextmanager
def traced(on: bool):
    """A profiler over the block when ``on``, else nothing; yields it."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(prof, window_s: float) -> dict | None:
    """The facts of a traced window of ``window_s`` host seconds."""
    if prof is None:
        return None
    dev_ev, host_ev = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ev.append(e)
        else:
            host_ev.append(e)
    if not dev_ev:
        return None
    by_name: dict[str, float] = {}
    iv = []
    for e in dev_ev:
        a, b = e.time_range.start, e.time_range.end
        iv.append((a, b))
        low = e.name.lower()
        if "memcpy" in low or "memset" in low:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
    segs = _union(iv)
    busy = sum(b - a for a, b in segs) / 1e6
    syncs = sum(1 for e in host_ev if e.name in SYNC_CALLS)
    # idle gaps between busy segments, named by the innermost host
    # operation under the gap's midpoint
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(segs, segs[1:])),
                  key=lambda g: g[0] - g[1])[:200]
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in host_ev), key=lambda t: t[0])
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        inner = [(b - a, n) for a, b, n in host[max(0, i - 5000):i]
                 if mid <= b]
        name = min(inner)[1] if inner else "(host Python outside torch ops)"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": window_s,
        "busy_s": busy,
        "syncs": syncs,
        "kernel_s": by_name,
        "device_ops": [[n, s] for n, s in top[:10]],
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def seconds_of(trace: dict, *parts: str) -> float | None:
    """Device seconds of the kernels whose names hold one of ``parts``;
    None where the record has none of them."""
    hits = [s for n, s in trace["kernel_s"].items()
            if any(p in n for p in parts)]
    return sum(hits) if hits else None
