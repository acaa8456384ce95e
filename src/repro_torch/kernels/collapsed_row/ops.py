"""Wrapper of the collapsed_row kernel (``csrc/collapsed_row.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel on the current stream or raise. The scalars q, N and inv2s2 are
0-d device tensors, read by the kernel, so a launch needs no host sync.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_cpu, stream

from .ref import collapsed_row_flip_ref

Tensor = torch.Tensor
counter = _build.counter("collapsed_row")
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _launch():
    return _build.function("collapsed_row", "collapsed_row_launch",
                           [_I] + [_P] * 16 + [_I] * 2 + [_P])


def collapsed_row_flip(M, H, x_n, z, v, q, mean, u, m_minus, active_m, N,
                       inv2s2):
    """The K-sequential bit-flip recurrence of one row; returns
    (z, v, q, mean). Arguments as in ``ref.collapsed_row_flip_ref``."""
    name = "collapsed_row"
    args = (M, H, x_n, z, v, q, mean, u, m_minus, active_m, N, inv2s2)
    if on_cpu(name, *args):
        return collapsed_row_flip_ref(*args)
    K, D = H.shape
    expect(name, (torch.float32,), M=(M, (K, K)), H=(H, (K, D)),
           x_n=(x_n, (D,)), z=(z, (K,)), v=(v, (K,)), q=(q, ()),
           mean=(mean, (D,)), u=(u, (K,)), m_minus=(m_minus, (K,)),
           active_m=(active_m, (K,)), N=(N, ()), inv2s2=(inv2s2, ()))
    zo = torch.empty_like(z)
    vo = torch.empty_like(v)
    qo = torch.empty_like(q)
    mo = torch.empty_like(mean)
    rc = _launch()(x_n.device.index,
                   *(t.data_ptr() for t in (*args, zo, vo, qo, mo)), K, D,
                   stream(x_n))
    _build.check(rc, name)
    counter.launches += 1
    return zo, vo, qo, mo
