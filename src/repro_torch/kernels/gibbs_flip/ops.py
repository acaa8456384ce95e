"""Wrapper of the gibbs_flip kernel (``csrc/gibbs_flip.cu``).

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel on the current stream or raise. The kernel sweeps in Gram form:
G = A A^T over the active columns goes to a float64 scratch of K*K
entries allocated here; K is at most ``gibbs_flip_max_k(device)`` on the
card (7808 on an H100).
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
def _launch():
    return _build.function("gibbs_flip", "gibbs_flip_launch",
                           [_I] + [_P] * 9 + [_I] * 3 + [_P])


@functools.cache
def gibbs_flip_max_k(device: torch.device) -> int:
    """The most columns K the kernel takes on CUDA device ``device``
    (bounded by the shared memory of its per-column arrays)."""
    max_k = _build.function("gibbs_flip", "gibbs_flip_max_k", [_I])
    return max_k(torch.device(device).index or 0)


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
    max_k = gibbs_flip_max_k(X.device)
    if K > max_k:
        raise ValueError(f"{name}: K={K} columns, the kernel takes at most "
                         f"{max_k} on {X.device}")
    out = torch.empty_like(Z)
    gram = torch.empty((K * K,), dtype=torch.float64, device=X.device)
    bufs = (X, Z, A, logit_pi, active, u_logit, inv2s2, gram, out)
    rc = _launch()(X.device.index, *(t.data_ptr() for t in bufs), N, D, K,
                stream(X))
    _build.check(rc, name)
    counter.launches += 1
    return out
