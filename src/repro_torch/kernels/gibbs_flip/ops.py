"""Wrapper of the gibbs_flip kernel (``csrc/gibbs_flip.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel on the current stream or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import expect, on_cpu, stream

from .ref import gibbs_flip_ref

Tensor = torch.Tensor
counter = _build.counter("gibbs_flip")
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _fns():
    launch = _build.function("gibbs_flip", "gibbs_flip_launch",
                             [_I] + [_P] * 10 + [_I] * 3 + [_P])
    scratch = _build.function("gibbs_flip", "gibbs_flip_scratch_floats",
                              [_I, _I], ctypes.c_long)
    return launch, scratch


def gibbs_flip_core(
    X: Tensor,         # (N, D) float32
    Z: Tensor,         # (N, K) float32 in {0,1}
    A: Tensor,         # (K, D) float32
    logit_pi: Tensor,  # (K,)
    active: Tensor,    # (K,)
    u_logit: Tensor,   # (N, K) logit-uniforms
    inv2s2: Tensor,    # () = 1 / (2 sigma_x^2)
) -> Tensor:
    """One sweep of Z | pi, A over all K columns; returns the new Z."""
    name = "gibbs_flip"
    if on_cpu(name, X, Z, A, logit_pi, active, u_logit, inv2s2):
        return gibbs_flip_ref(X, Z, A, logit_pi, active, u_logit, inv2s2)
    N, D = X.shape
    K = Z.shape[1]
    expect(name, (torch.float32,), X=(X, (N, D)), Z=(Z, (N, K)),
           A=(A, (K, D)), logit_pi=(logit_pi, (K,)), active=(active, (K,)),
           u_logit=(u_logit, (N, K)), inv2s2=(inv2s2, ()))
    launch, scratch = _fns()
    out = torch.empty_like(Z)
    anorm = torch.empty((K,), dtype=torch.float32, device=X.device)
    rg = torch.empty((scratch(N, D),), dtype=torch.float32, device=X.device)
    bufs = (X, Z, A, logit_pi, active, u_logit, inv2s2, anorm, out, rg)
    rc = launch(X.device.index, *(t.data_ptr() for t in bufs), N, D, K,
                stream(X))
    _build.check(rc, name)
    counter.launches += 1
    return out
