"""Plain PyTorch version of the collapsed_row kernel.

The K-sequential collapsed Gibbs bit-flip recurrence for ONE row n of Z
(Griffiths & Ghahramani posterior-predictive form), port of
``repro/kernels/collapsed_row/ref.py``. Given the row-deleted posterior
map M = (Z_-^T Z_- + r I)^{-1} (masked to active columns), H = M Z_-^T
X_-, and the carried quadratic state (v = M z, q = z^T M z, mean = z H),
flip every bit k in order:

    x_n | z ~ N( z H,  sigma_x^2 (1 + z M z^T) I )

with prior odds m_k / (N - m_k). Each step moves (v, q, mean) by
(+-M[:, k], +-2 v_k + M_kk, +-H[k]) instead of re-solving.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def collapsed_row_flip_ref(
    M: Tensor,         # (K, K) masked posterior map, symmetric
    H: Tensor,         # (K, D) posterior mean map
    x_n: Tensor,       # (D,) the row's observation (or residual)
    z: Tensor,         # (K,) current bits
    v: Tensor,         # (K,) = M @ z
    q: Tensor,         # ()   = z @ v
    mean: Tensor,      # (D,) = z @ H
    u: Tensor,         # (K,) logit-uniform accept thresholds
    m_minus: Tensor,   # (K,) column counts with row n removed
    active_m: Tensor,  # (K,) live-column mask
    N: Tensor,         # ()   GLOBAL observation count (prior odds)
    inv2s2: Tensor,    # ()   = 1 / (2 sigma_x^2)
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (z, v, q, mean) after one in-order pass over all K bits."""
    D = x_n.shape[0]
    # per-bit operands as views (one op each instead of one per bit); the
    # prior log-odds and the may-flip mask are elementwise, so computing
    # them for all bits at once gives the same values as bit by bit
    cols = M.T.unbind(0)           # cols[k] = M[:, k]
    Mkk = torch.diagonal(M).unbind(0)
    Hk = H.unbind(0)
    uk = u.unbind(0)
    prior = (torch.log(torch.clamp(m_minus, min=1e-20))
             - torch.log(N - m_minus)).unbind(0)
    may = (active_m > 0) & (m_minus > 0.5)
    # a bit that may not flip and is 0 moves nothing (every move is
    # 0 * column, added to the carry): skipping it is exact. The skip is
    # read on the host, so on a CUDA tensor every bit runs instead and
    # the pass never waits on the device
    skip = ((~may & (z == 0)).tolist() if z.device.type == "cpu"
            else [False] * z.shape[0])
    may = may.unbind(0)
    zs = list(z.unbind(0))
    for k in range(len(zs)):
        if skip[k]:
            continue
        zk = zs[k]
        # state with bit k = 0
        v0 = v - zk * cols[k]
        q0 = q - zk * (2.0 * v[k] - Mkk[k])
        mean0 = mean - zk * Hk[k]
        # state with bit k = 1
        v1 = v0 + cols[k]
        q1 = q0 + 2.0 * v0[k] + Mkk[k]
        mean1 = mean0 + Hk[k]
        s0 = 1.0 + q0
        s1 = 1.0 + q1
        r0 = x_n - mean0
        r1 = x_n - mean1
        ll0 = -0.5 * D * torch.log(s0) - inv2s2 * torch.dot(r0, r0) / s0
        ll1 = -0.5 * D * torch.log(s1) - inv2s2 * torch.dot(r1, r1) / s1
        logodds = prior[k] + ll1 - ll0
        # sample; only live columns with support may flip
        znk = torch.where(may[k], (logodds > uk[k]).to(z.dtype), zk)
        pick1 = znk > 0.5
        v = torch.where(pick1, v1, v0)
        q = torch.where(pick1, q1, q0)
        mean = torch.where(pick1, mean1, mean0)
        zs[k] = znk
    return torch.stack(zs), v, q, mean
