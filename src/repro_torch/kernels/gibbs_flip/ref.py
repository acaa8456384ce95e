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


def gibbs_flip_gram_ref(
    X: Tensor,         # (N, D)
    Z: Tensor,         # (N, K) in {0,1}
    A: Tensor,         # (K, D)
    logit_pi: Tensor,  # (K,)
    active: Tensor,    # (K,) in {0,1}
    u_logit: Tensor,   # (N, K) logit-uniforms
    inv2s2: Tensor,    # () = 1 / (2 sigma_x^2)
) -> Tensor:
    """The same sweep in the Gram form of the CUDA kernel, with its
    precision: P = X A^T summed in float32 over each 64-wide chunk of D,
    the chunks added in float64 in ascending order; G = A A^T and the
    carry C = Z G in float64. With s0_k = P_k - C_k + z_k G_kk, a flip of
    z_k by delta moves C by delta G_k. Used by the tests only."""
    N, D = X.shape
    X32, A32 = X.float(), A.float()
    P = torch.zeros((N, Z.shape[1]), dtype=torch.float64, device=X.device)
    for d0 in range(0, D, 64):
        P += (X32[:, d0:d0 + 64] @ A32[:, d0:d0 + 64].T).double()
    A64 = A.double()
    G = A64 @ A64.T
    Z64 = Z.double()
    C = Z64 @ G
    i2 = torch.as_tensor(inv2s2, dtype=torch.float64)
    for k in torch.nonzero(active > 0).flatten().tolist():
        z_k = Z64[:, k].clone()
        s0 = P[:, k] - C[:, k] + z_k * G[k, k]
        logits = logit_pi[k].double() + (2.0 * s0 - G[k, k]) * i2
        znew = (logits > u_logit[:, k].double()).double()
        C += (znew - z_k)[:, None] * G[k][None, :]
        Z64[:, k] = znew
    return Z64.to(Z.dtype)
