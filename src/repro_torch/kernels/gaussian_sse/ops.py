"""Wrapper of the gaussian_sse kernel (``csrc/gaussian_sse.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel on the current stream or raise. X, Z, A and active share one
dtype, float32 or bfloat16; Z may hold any values, active is the
sampler's 0/1 mask (the bfloat16 kernel rounds z*active to bfloat16,
exact for a 0/1 mask); the result is a float32 0-d tensor. The kernel's
partial sums go to a float64 scratch allocated here, one per block of
its first pass.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_cpu, stream

from .ref import gaussian_sse_ref

Tensor = torch.Tensor
counter = _build.counter("gaussian_sse")
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fns():
    launch = _build.function("gaussian_sse", "gaussian_sse_launch",
                             [_I] + [_P] * 6 + [_I] * 4 + [_P])
    blocks = _build.function("gaussian_sse", "gaussian_sse_blocks", [_I] * 3)
    return launch, blocks


def gaussian_sse(X: Tensor, Z: Tensor, A: Tensor, active: Tensor) -> Tensor:
    """||X - (Z*active) A||^2 as a float32 0-d tensor."""
    name = "gaussian_sse"
    if on_cpu(name, X, Z, A, active):
        return gaussian_sse_ref(X, Z, A, active)
    N, D = X.shape
    K = Z.shape[1]
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: X has dtype {X.dtype}, expected float32 "
                        f"or bfloat16")
    expect(name, (X.dtype,), X=(X, (N, D)), Z=(Z, (N, K)), A=(A, (K, D)),
           active=(active, (K,)))
    launch, blocks = _fns()
    partial = torch.empty((blocks(X.device.index, N, D),),
                          dtype=torch.float64, device=X.device)
    out = torch.empty((), dtype=torch.float32, device=X.device)
    rc = launch(X.device.index,
                *(t.data_ptr() for t in (X, Z, A, active, partial, out)),
                N, D, K, int(X.dtype == torch.bfloat16), stream(X))
    _build.check(rc, name)
    counter.launches += 1
    return out
