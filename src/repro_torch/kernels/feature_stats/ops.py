"""Wrapper of the feature_stats kernel (``csrc/feature_stats.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel on the current stream or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_cpu, stream

from .ref import feature_stats_ref

Tensor = torch.Tensor
counter = _build.counter("feature_stats")
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fns():
    launch = _build.function("feature_stats", "feature_stats_launch",
                             [_I] + [_P] * 6 + [_I] * 3 + [_P])
    workspace = _build.function("feature_stats",
                                "feature_stats_workspace_floats", [_I] * 4,
                                ctypes.c_long)
    return launch, workspace


def feature_stats(X: Tensor, Z: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Returns (ZtZ (K,K), ZtX (K,D), m (K,)), float32."""
    name = "feature_stats"
    if on_cpu(name, X, Z):
        return feature_stats_ref(X, Z)
    N, D = X.shape
    K = Z.shape[1]
    expect(name, (torch.float32,), X=(X, (N, D)), Z=(Z, (N, K)))
    ztz = torch.empty((K, K), dtype=torch.float32, device=X.device)
    ztx = torch.empty((K, D), dtype=torch.float32, device=X.device)
    m = torch.empty((K,), dtype=torch.float32, device=X.device)
    launch, workspace = _fns()
    ws = torch.empty((workspace(X.device.index, N, D, K),),
                     dtype=torch.float32, device=X.device)
    rc = launch(X.device.index,
                *(t.data_ptr() for t in (X, Z, ztz, ztx, m, ws)), N, D, K,
                stream(X))
    _build.check(rc, name)
    counter.launches += 1
    return ztz, ztx, m
