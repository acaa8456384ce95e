"""Plain PyTorch version of the gibbs_flip kernel.

One uncollapsed Gibbs sweep of Z | pi, A over all K columns (sequential
in k, vectorized over rows), with pre-drawn logit-uniforms. Port of
``repro/kernels/gibbs_flip/ref.py`` and of the sweep body of
``repro/core/ibp/sweeps.py::_uncollapsed_sweep_jnp``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def gibbs_flip_ref(
    X: Tensor,         # (N, D)
    Z: Tensor,         # (N, K) in {0,1}
    A: Tensor,         # (K, D)
    logit_pi: Tensor,  # (K,)
    active: Tensor,    # (K,) in {0,1}
    u_logit: Tensor,   # (N, K) logit-uniforms
    inv2s2: Tensor,    # () = 1 / (2 sigma_x^2)
) -> Tensor:
    R = X - Z @ A
    anorm2 = torch.sum(A * A, dim=1)
    Z = Z.clone()
    for k in range(Z.shape[1]):
        a_k = A[k]
        z_k = Z[:, k]
        R0 = R + z_k[:, None] * a_k[None, :]
        dll = (2.0 * (R0 @ a_k) - anorm2[k]) * inv2s2
        logits = logit_pi[k] + dll
        znew = torch.where(active[k] > 0, (logits > u_logit[:, k]).to(Z.dtype),
                           z_k)
        R = R0 - znew[:, None] * a_k[None, :]
        Z[:, k] = znew
    return Z
