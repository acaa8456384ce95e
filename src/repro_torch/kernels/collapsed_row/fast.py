"""Plain PyTorch version of the rss form of the collapsed bit-flip
recurrence, port of ``repro/kernels/collapsed_row/fast.py``.

The same posterior-predictive decisions as ``collapsed_row_flip_ref``
with O(K) work per bit instead of O(K + D): the likelihood reads the
residual only through its norm, so the recurrence carries rss =
‖x − zH‖² and rH = H (x − zH) instead of the (D,) mean. Flipping bit k
moves them by (±2 rH_k + G_kk, ∓G[k]) with G = H Hᵀ, which the collapsed
scan carries across rows and passes in; without ``G`` it is computed
here (one O(K²D) product). The mean is rebuilt once, z H, on exit. Only
the live columns are visited, in ascending order: a dead column is a
no-op of the recurrence. The sums are taken in another order than the
mean form's, so decisions can differ from it at float-boundary events.

This is the plain version of the recurrence that the ``collapsed_scan``
kernel runs for its ``"fast"`` flavor (``csrc/collapsed_row.cuh``).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def collapsed_row_flip_fast(
    M: Tensor,         # (K, K) masked posterior map, symmetric
    H: Tensor,         # (K, D) posterior mean map
    x_n: Tensor,       # (D,)
    z: Tensor,         # (K,)
    v: Tensor,         # (K,) = M @ z
    q: Tensor,         # ()   = z @ v
    mean: Tensor,      # (D,) = z @ H
    u: Tensor,         # (K,) logit-uniform accept thresholds
    m_minus: Tensor,   # (K,)
    active_m: Tensor,  # (K,)
    N: Tensor,         # ()
    inv2s2: Tensor,    # ()
    G: Tensor | None = None,  # (K, K) = H Hᵀ, carried by the caller
    rss_rH: tuple[Tensor, Tensor] | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (z, v, q, mean); see ``collapsed_row_flip_ref``.

    ``rss_rH`` = (‖x − mean‖², H (x − mean)) where the caller has them in
    closed form (the collapsed scan after a plain row removal); else they
    are computed here from ``mean``."""
    D = x_n.shape[0]
    if G is None:
        G = H @ H.T
    if rss_rH is None:
        r = x_n - mean
        rss, rH = torch.dot(r, r), H @ r
    else:
        rss, rH = rss_rH
    logprior = (torch.log(torch.clamp(m_minus, min=1e-20))
                - torch.log(N - m_minus)).unbind(0)
    Mr, Gr, uk = M.unbind(0), G.unbind(0), u.unbind(0)
    zs = list(z.unbind(0))
    may_all = (m_minus > 0.5).tolist()
    live = torch.nonzero(active_m > 0.5).flatten().tolist()
    for k in live:
        zk, may = zs[k], may_all[k]
        if not may and not bool(zk):
            continue  # moves nothing: every move is 0 * a row of M or G
        Mk, Gk = Mr[k], Gr[k]   # rows read as columns (M, G symmetric)
        Mkk, Gkk = Mk[k], Gk[k]
        # state with bit k = 0
        v0 = v - zk * Mk
        q0 = q - zk * (2.0 * v[k] - Mkk)
        rH0 = rH + zk * Gk
        rss0 = rss + zk * (2.0 * rH[k] + Gkk)
        # state with bit k = 1
        v1 = v0 + Mk
        q1 = q0 + 2.0 * v0[k] + Mkk
        rss1 = rss0 - 2.0 * rH0[k] + Gkk
        s0 = 1.0 + q0
        s1 = 1.0 + q1
        ll0 = -0.5 * D * torch.log(s0) - inv2s2 * rss0 / s0
        ll1 = -0.5 * D * torch.log(s1) - inv2s2 * rss1 / s1
        logodds = logprior[k] + ll1 - ll0
        znk = (logodds > uk[k]).to(z.dtype) if may else zk
        pick1 = znk > 0.5
        v = torch.where(pick1, v1, v0)
        q = torch.where(pick1, q1, q0)
        rss = torch.where(pick1, rss1, rss0)
        rH = torch.where(pick1, rH0 - Gk, rH0)
        zs[k] = znk
    z = torch.stack(zs)
    return z, v, q, z @ H
