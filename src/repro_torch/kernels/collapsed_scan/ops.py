"""Wrapper of the collapsed_scan kernel (``csrc/collapsed_scan.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel on the current stream or raise. One launch scans a segment of
rows; sx, sa and (for Gibbs births) alpha are 0-d device tensors read by
the kernel, the packed block is gathered and scattered back by index ops
on the device, and the counts come back in a device tensor, so a scan
needs no host sync.

A chained scan (a leading chain axis C on every per-chain input) scans C
independent chains' tails in one launch of C blocks, one chain a block:
MH births on the full width from row 0, the hybrid tail's case.

Inside ``tracing.recording()``, a scan with MH births (the hybrid
tail's) passes the record's device buffer, and the launch adds its row
phases' cycles to it (the kernel's TRACE instances, for the rss flip
with the carry in shared memory); otherwise, a profiler on or not, it
passes none and the kernel runs its untraced instance.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_cpu, stream

from .ref import FLAVORS, J_MAX, collapsed_scan_ref, gather_block, scatter_block

Tensor = torch.Tensor
counter = _build.counter("collapsed_scan")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _fns():
    launch = _build.function(
        "collapsed_scan", "collapsed_scan_launch",
        [_I] + [_P] * 16 + [_I] * 5 + [_F, _I, _F, _I, _I, _I, _P, _P])
    scratch = _build.function("collapsed_scan",
                              "collapsed_scan_scratch_floats", [_I] * 3,
                              ctypes.c_long)
    return launch, scratch


def collapsed_scan(Z, active, ZtZ, ZtX, m, X, u_logit, j_prop, log_u_acc,
                   sx, sa, *, N: float, refresh_every: int, drift_tol: float,
                   gumbel: Tensor | None = None,
                   alpha: Tensor | None = None, flavor: str = "pallas",
                   B: int | None = None, start_row: int = 0) -> Tensor:
    """Scan rows ``start_row``.. of ``X`` on the packed block of ``B``
    columns (default all) with the flip ``flavor``; updates Z, active,
    ZtZ, ZtX and m in place and returns the int32 counts (n_refresh,
    n_sat, ovf_row). Births are MH moves from ``j_prop`` and
    ``log_u_acc``, or Gibbs draws from ``gumbel`` and ``alpha`` when
    ``gumbel`` is given. Arguments as in ``ref.collapsed_scan_ref``.

    Precondition, not checked here (it would be a host read): the block
    holds every live column, ``B >= sum(active)``. A smaller block would
    leave live columns out, and writing the block back zeroes their
    statistics.

    Chained: Z (C, n_rows, K), active (C, K), ZtZ (C, K, K), ZtX (C, K,
    D), m (C, K), X (C, n_rows, D), u_logit (C, n_rows, K), j_prop and
    log_u_acc (C, n_rows), sx and sa (C,): C independent scans, MH births
    on the full width (B = K) from row 0, in one launch on the card;
    returns counts (C, 3)."""
    name = "collapsed_scan"
    gibbs = gumbel is not None
    births = (gumbel, alpha) if gibbs else (j_prop, log_u_acc)
    if any(t is None for t in births):
        need = "gumbel and alpha" if gibbs else "j_prop and log_u_acc"
        raise ValueError(f"{name}: {need} are needed for its births")
    if flavor not in FLAVORS:
        raise ValueError(f"{name}: flavor={flavor!r} not in {FLAVORS}")
    chained = Z.dim() == 3
    lead = tuple(Z.shape[:1]) if chained else ()
    n_rows, K = Z.shape[-2:]
    D = X.shape[-1]
    B = K if B is None else B
    if not (1 <= B <= K and 0 <= start_row <= n_rows):
        raise ValueError(f"{name}: B={B} must be in [1, {K}] and "
                         f"start_row={start_row} in [0, {n_rows}]")
    if chained and (gibbs or B != K or start_row != 0):
        raise ValueError(f"{name}: a chained scan takes MH births on the "
                         f"full width from row 0 (gibbs={gibbs}, B={B} of "
                         f"K={K}, start_row={start_row})")
    args = (Z, active, ZtZ, ZtX, m, X, u_logit, j_prop, log_u_acc, sx, sa)
    kw = dict(N=N, refresh_every=refresh_every, drift_tol=drift_tol,
              gumbel=gumbel, alpha=alpha, flavor=flavor, B=B,
              start_row=start_row)
    if on_cpu(name, *(t for t in (*args, *births) if t is not None)):
        return collapsed_scan_ref(*args, **kw)
    draws = (dict(gumbel=(gumbel, (n_rows, J_MAX + 1)), alpha=(alpha, ()))
             if gibbs else dict(j_prop=(j_prop, (*lead, n_rows)),
                                log_u_acc=(log_u_acc, (*lead, n_rows))))
    expect(name, (torch.float32,), Z=(Z, (*lead, n_rows, K)),
           active=(active, (*lead, K)), ZtZ=(ZtZ, (*lead, K, K)),
           ZtX=(ZtX, (*lead, K, D)), m=(m, (*lead, K)),
           X=(X, (*lead, n_rows, D)), u_logit=(u_logit, (*lead, n_rows, K)),
           sx=(sx, lead), sa=(sa, lead), **draws)
    launch, scratch = _fns()
    C = lead[0] if chained else 1
    canon = (active, ZtZ, ZtX, m)
    if chained:  # the full width: the kernel moves the buffers in place
        cols, block = torch.arange(K, device=X.device), canon
    else:
        cols, _, block = gather_block(*canon, B)
        block = tuple(t.contiguous() for t in block)
    counts = torch.empty((*lead, 3), dtype=torch.int32, device=X.device)
    arena = torch.empty((C * scratch(X.device.index, B, D),),
                        dtype=torch.float32, device=X.device)
    cycles = None if gibbs else tracing.scan_buffer(X.device, C)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = launch(X.device.index,
                *(ptr(t) for t in (Z, *block, X, u_logit, j_prop, log_u_acc,
                                   gumbel, sx, sa, alpha, cols, counts,
                                   arena)),
                n_rows, K, B, D, start_row, float(N), int(refresh_every),
                float(drift_tol), int(gibbs), int(flavor == "fast"), C,
                stream(X), ptr(cycles))
    _build.check(rc, name)
    counter.launches += 1
    if B < K:
        scatter_block(cols, block, canon)
    return counts
