"""Wrapper of the collapsed_scan kernel (``csrc/collapsed_scan.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel on the current stream or raise. One launch scans every row; sx,
sa and (for Gibbs births) alpha are 0-d device tensors read by the
kernel, and the counts come back in a device tensor, so a scan needs no
host sync.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_cpu, stream

from .ref import J_MAX, collapsed_scan_ref

Tensor = torch.Tensor
counter = _build.counter("collapsed_scan")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _fns():
    launch = _build.function(
        "collapsed_scan", "collapsed_scan_launch",
        [_I] + [_P] * 15 + [_I] * 3 + [_F, _I, _F, _I, _P])
    scratch = _build.function("collapsed_scan",
                              "collapsed_scan_scratch_floats", [_I] * 3,
                              ctypes.c_long)
    return launch, scratch


def collapsed_scan(Z, active, ZtZ, ZtX, m, X, u_logit, j_prop, log_u_acc,
                   sx, sa, *, N: float, refresh_every: int, drift_tol: float,
                   gumbel: Tensor | None = None,
                   alpha: Tensor | None = None) -> Tensor:
    """Scan every row of ``X``; updates Z, active, ZtZ, ZtX and m in place
    and returns the int32 counts (n_refresh, n_sat). Births are MH moves
    from ``j_prop`` and ``log_u_acc``, or Gibbs draws from ``gumbel`` and
    ``alpha`` when ``gumbel`` is given. Arguments as in
    ``ref.collapsed_scan_ref``."""
    name = "collapsed_scan"
    gibbs = gumbel is not None
    births = (gumbel, alpha) if gibbs else (j_prop, log_u_acc)
    if any(t is None for t in births):
        need = "gumbel and alpha" if gibbs else "j_prop and log_u_acc"
        raise ValueError(f"{name}: {need} are needed for its births")
    args = (Z, active, ZtZ, ZtX, m, X, u_logit, j_prop, log_u_acc, sx, sa)
    kw = dict(N=N, refresh_every=refresh_every, drift_tol=drift_tol,
              gumbel=gumbel, alpha=alpha)
    if on_cpu(name, *(t for t in (*args, *births) if t is not None)):
        return collapsed_scan_ref(*args, **kw)
    n_rows, D = X.shape
    K = Z.shape[1]
    draws = (dict(gumbel=(gumbel, (n_rows, J_MAX + 1)), alpha=(alpha, ()))
             if gibbs else dict(j_prop=(j_prop, (n_rows,)),
                                log_u_acc=(log_u_acc, (n_rows,))))
    expect(name, (torch.float32,), Z=(Z, (n_rows, K)), active=(active, (K,)),
           ZtZ=(ZtZ, (K, K)), ZtX=(ZtX, (K, D)), m=(m, (K,)),
           X=(X, (n_rows, D)), u_logit=(u_logit, (n_rows, K)),
           sx=(sx, ()), sa=(sa, ()), **draws)
    launch, scratch = _fns()
    counts = torch.empty((2,), dtype=torch.int32, device=X.device)
    arena = torch.empty((scratch(X.device.index, K, D),), dtype=torch.float32,
                        device=X.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = launch(X.device.index,
                *(ptr(t) for t in (Z, active, ZtZ, ZtX, m, X, u_logit,
                                   j_prop, log_u_acc, gumbel, sx, sa, alpha,
                                   counts, arena)),
                n_rows, K, D, float(N), int(refresh_every), float(drift_tol),
                int(gibbs), stream(X))
    _build.check(rc, name)
    counter.launches += 1
    return counts
