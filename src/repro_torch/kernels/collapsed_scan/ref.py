"""Plain PyTorch version of the collapsed_scan kernel: the collapsed row
scan over every row of a block of rows.

Port of what ``repro/core/ibp/collapsed.py`` runs for the hybrid tail
and for the serial collapsed sweep: ``collapsed_row_scan(..., backend=
"pallas")`` with ``birth="mh"`` (the tail) or ``birth="gibbs"`` (the
sweep), which is ``_packed_scan`` at the full-width block B = K with
``carry_g=False``. At that point a birth cannot overflow the block, so
the block gather, the overflow exit and resume and the G = HHᵀ carry are
dead code in the reference and are not ported; the reference's hoisted
(or, for the sweep, chunked) uniforms are drawn up front and passed in.

Per row n, with A integrated out (Griffiths & Ghahramani):

    x_n | z_n, Z_-n, X_-n ~ N( z_n H_-,  sigma_x^2 (1 + z_n M_- z_n^T) I )

with M_- = (Z_-^T Z_- + (sx^2/sa^2) I)^{-1} and H_- = M_- Z_-^T X_-. The
factor (Lt = L^T, M, H) is carried across rows: removing a row is one
Sherman–Morrison move plus a rank-one Cholesky downdate, adding it back
one update; singleton drops and births are diagonal identity swaps. An
exact refactorization runs every ``refresh_every`` rows, and earlier when
the downdate loses positive definiteness or the drift probe (every
``PROBE_EVERY`` rows, ‖M W p − p‖∞ against the exact statistics) exceeds
``drift_tol``. The bit flips are the ``collapsed_row`` recurrence (its
plain version here). New dishes are either the paper's MH move (j ~
Poisson(alpha/N), accepted with the marginal-likelihood ratio) or the
exact truncated Gibbs draw over j = 0..J_MAX, taken as the argmax of the
log posterior plus pre-drawn Gumbel noise, which is how
``jax.random.categorical`` draws it.

The reference's ``lax.cond``s are Python ``if``s on flags read from the
tensors (``.tolist()``), so on a CUDA tensor each row waits on the device
twice; this version is the kernel's arithmetic spelled out, for the CPU
and for checking the kernel, not a path the sampler takes on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.collapsed_row import collapsed_row_flip_ref
from repro_torch.linalg import (
    chol_inv,
    chol_rank1_downdate_t,
    chol_rank1_update_t,
    mask_outer,
    padded_W,
)

Tensor = torch.Tensor

J_MAX = 4  # per-row new-dish truncation (P(j>4 | alpha/N) is negligible)
PROBE_EVERY = 4  # drift-probe cadence within the refresh window
BIRTHS = ("mh", "gibbs")
# log j! for j = 0..J_MAX, rounded to float32 (the kernel's table)
LOG_FACT = (0.0, 0.0, math.log(2.0), math.log(6.0), math.log(24.0))


def _log_poisson(j: Tensor, lam: Tensor) -> Tensor:
    """log Poisson(j; lam) for j = 0..J_MAX, float32, in the reference's
    order of terms; log j! from the table (the reference's float32
    lgamma is off the rounded value by up to 1e-6)."""
    log_fact = torch.tensor(LOG_FACT, dtype=j.dtype, device=j.device)
    return j * torch.log(lam) - lam - log_fact


def _sample_dishes(birth, draw, q, mean, x_n, active_m, z, sx, sa, lam, D):
    """The new-dish move: returns (z', active', newbits, sat).

    ``birth="mh"``: ``draw`` is (j_prop, log_u_acc). Propose j ~
    Poisson(alpha/N) (pre-drawn) and accept with the marginal-likelihood
    ratio lik(j)/lik(0) (prior ∝ proposal, so they cancel); proposals
    beyond the free capacity are rejected. ``sat`` is the tail-saturation
    flag: the likelihood accepted a proposal (j ≤ J_MAX) that only the
    lack of free columns vetoed.

    ``birth="gibbs"``: ``draw`` is the row's J_MAX + 1 standard Gumbel
    values g. j_new is the first argmax over j ≤ n_free of log
    Poisson(j; lam) + lik(j) + g_j, an exact draw from the truncated
    conditional; ``sat`` is always False (the sweep's capacity is K_max).
    ``lam`` = alpha / N is read by this mode only.
    """
    inv2s2 = 0.5 / (sx**2)
    s = 1.0 + q
    r = x_n - mean
    rss = torch.dot(r, r)
    js = torch.arange(J_MAX + 1, dtype=x_n.dtype, device=x_n.device)
    rho = (sa / sx) ** 2
    s_j = s + js * rho
    ll_j = -0.5 * D * torch.log(s_j) - inv2s2 * rss / s_j
    free = 1.0 - torch.maximum(active_m, z)
    n_free = torch.sum(free)
    if birth == "gibbs":
        logits = _log_poisson(js, lam) + ll_j
        logits = torch.where(js <= n_free, logits, -torch.inf)
        j_new = torch.argmax(draw + logits).to(x_n.dtype)
        sat = torch.zeros((), dtype=torch.bool, device=x_n.device)
    else:
        j_prop, log_u_acc = draw
        ok = j_prop <= torch.clamp(n_free, max=float(J_MAX))
        j_idx = torch.clamp(j_prop, 0, J_MAX).long().reshape(1)
        dll = ll_j.index_select(0, j_idx)[0] - ll_j[0]
        acc = log_u_acc < dll
        j_new = torch.where(ok & acc, j_prop, torch.zeros_like(j_prop))
        sat = acc & (j_prop <= float(J_MAX)) & (j_prop > n_free)
    # place new dishes in the first j_new free slots
    free_rank = torch.cumsum(free, 0) * free  # 1-indexed rank among free slots
    newbits = ((free_rank >= 1.0) & (free_rank <= j_new)).to(z.dtype)
    return z + newbits, torch.maximum(active_m, newbits), newbits, sat


def _exact_factor(ZtZ, ZtX, active, ratio):
    """O(K^3 + K^2 D) exact (Lt, M, H) from the sufficient statistics."""
    L, M = chol_inv(padded_W(ZtZ, active, ratio))
    M = M * mask_outer(active)
    H = M @ (ZtX * active[:, None])
    return L.T, M, H


def collapsed_scan_ref(
    Z: Tensor,          # (n_rows, K) bits, updated in place
    active: Tensor,     # (K,) live-column mask, updated in place
    ZtZ: Tensor,        # (K, K) statistics, updated in place
    ZtX: Tensor,        # (K, D)
    m: Tensor,          # (K,) column counts
    X: Tensor,          # (n_rows, D) the rows (data, or the tail's residual)
    u_logit: Tensor,    # (n_rows, K) logit-uniform bit-flip thresholds
    j_prop: Tensor | None,     # (n_rows,) MH birth proposals, Poisson(alpha/N)
    log_u_acc: Tensor | None,  # (n_rows,) log of the MH accept uniforms
    sx: Tensor,         # () sigma_x
    sa: Tensor,         # () sigma_a
    *,
    N: float,
    refresh_every: int,
    drift_tol: float,
    gumbel: Tensor | None = None,  # (n_rows, J_MAX + 1) Gibbs-birth noise
    alpha: Tensor | None = None,   # () IBP concentration (Gibbs births)
) -> Tensor:
    """Scan the collapsed row step over every row of ``X``.

    Births are MH moves from ``j_prop`` and ``log_u_acc``, or, when
    ``gumbel`` is given, Gibbs draws from it and ``alpha`` (the MH draws
    are then unused and may be None). ``N`` is the GLOBAL observation
    count: the tail runs on one shard's rows with global-N priors
    ((m_k - Z_nk)/N and Poisson(alpha/N)). Updates Z, active, ZtZ, ZtX
    and m in place and returns the int32 counts (n_refresh, n_sat):
    exact refactorizations and capacity-vetoed accepted MH births.
    """
    n_rows, D = X.shape
    dev, dt = X.device, X.dtype
    birth = "mh" if gumbel is None else "gibbs"
    lam = None if alpha is None else alpha / N
    ratio = (sx / sa) ** 2
    inv2s2 = 0.5 / (sx**2)
    N_t = torch.tensor(N, dtype=dt, device=dev)
    outs = (active, ZtZ, ZtX, m)  # the caller's buffers, written at the end
    Lt, M, H = _exact_factor(ZtZ, ZtX, active, ratio)
    since = n_refresh = n_sat = 0

    for n in range(n_rows):
        x_n = X[n]
        z_old = Z[n].clone()
        # ---- remove row n (Sherman–Morrison + the downdate direction)
        m_minus = m - z_old
        zu = z_old * active
        w = M @ zu
        p_down = Lt @ w
        gamma = torch.dot(zu, w)
        delta_s = torch.clamp(1.0 - gamma, min=1e-6)
        zH = zu @ H
        wr = w / torch.sqrt(delta_s)
        wd = w / delta_s
        b_rm = zH - x_n
        drop = active * (m_minus <= 0.5)
        z = z_old * (1.0 - drop)
        active_m = active * (1.0 - drop)
        # unconditional drop masking: without a drop the carry already
        # holds exact zeros on inactive rows/cols (a bitwise no-op)
        keep2 = mask_outer(active_m)
        M1 = (M + torch.outer(wr, wr)) * keep2
        H1 = (H + torch.outer(wd, b_rm)) * active_m[:, None]
        flags = [torch.all(1.0 - torch.cumsum(p_down * p_down, 0) > 1e-12),
                 torch.any(drop > 0.5)]
        probe = since % PROBE_EVERY == 0
        if probe:  # drift probe: ‖M W p − p‖∞ against the exact statistics
            tm = ZtZ @ active_m - z_old * torch.dot(z_old, active_m)
            probe_t = active_m * tm + ratio * active_m
            d_m = torch.max(torch.abs(M1 @ probe_t - active_m))
            flags.append(d_m <= drift_tol)
        flags = torch.stack(flags).tolist()
        down_ok, has_drop = flags[0], flags[1]
        need = (since >= refresh_every - 1 or not down_ok
                or (probe and not flags[2]))

        if need:  # exact refresh from the row-removed statistics
            Lt_rm, M1, H1 = _exact_factor(ZtZ - torch.outer(z_old, z_old),
                                          ZtX - torch.outer(z_old, x_n),
                                          active_m, ratio)
            since = 0
            n_refresh += 1
        else:
            since += 1

        # ---- bit flips: (v, q, mean) by mat-vec after a drop or a
        # refresh, in closed form after a plain removal
        if has_drop or need:
            v = M1 @ z
            q = torch.dot(z, v)
            mean = z @ H1
        else:
            q = gamma / delta_s
            v = wd
            mean = zH + q * (zH - x_n)
        z, v, q, mean = collapsed_row_flip_ref(
            M1, H1, x_n, z, v, q, mean, u_logit[n], m_minus, active_m, N_t,
            inv2s2)

        # ---- new dishes
        draw = gumbel[n] if birth == "gibbs" else (j_prop[n], log_u_acc[n])
        z2, active_new, newbits, sat = _sample_dishes(
            birth, draw, q, mean, x_n, active_m, z, sx, sa, lam, D)
        flags = torch.stack([torch.any(z2 != z_old),
                             torch.any(active_new != active),
                             torch.any(newbits > 0.5),
                             sat]).tolist()
        changed = need or flags[0] or flags[1]
        n_sat += int(flags[3])

        # ---- add row n back: statistics, then the factor
        if has_drop:
            ZtZ = ((ZtZ - torch.outer(z_old, z_old)) * keep2
                   + torch.outer(z2, z2))
            ZtX = ((ZtX - torch.outer(z_old, x_n)) * active_m[:, None]
                   + torch.outer(z2, x_n))
        elif changed:
            ZtZ = ZtZ + torch.outer(z2, z2) - torch.outer(z_old, z_old)
            ZtX = ZtX + torch.outer(z2 - z_old, x_n)
        if changed:
            Lt1 = Lt_rm if need else chol_rank1_downdate_t(Lt, p_down)[0]
            if has_drop or flags[2]:  # identity swaps of dropped/born slots
                Lt1 = Lt1 * keep2 + torch.diag(1.0 - active_m)
                Lt1 = Lt1 + torch.diag(newbits * (torch.sqrt(ratio) - 1.0))
                M1 = M1 + torch.diag(newbits / ratio)
                H1 = H1 * (1.0 - newbits)[:, None]
            w2 = M1 @ z2
            Lt = chol_rank1_update_t(Lt1, Lt1 @ w2)
            d2 = 1.0 + torch.dot(z2, w2)
            w2r = w2 / torch.sqrt(d2)
            b_add = x_n - z2 @ H1
            M = M1 - torch.outer(w2r, w2r)
            H = H1 + torch.outer(w2 / d2, b_add)

        Z[n] = z2
        active = active_new
        m = m_minus * active_m + z2
    for buf, val in zip(outs, (active, ZtZ, ZtX, m)):
        buf.copy_(val)
    return torch.tensor([n_refresh, n_sat], dtype=torch.int32, device=dev)
