"""Plain PyTorch version of the collapsed_scan kernel: the collapsed row
scan over a range of rows, on a packed block of columns.

Port of the reference's ``_packed_scan`` (``repro/core/ibp/collapsed.py``),
which both the hybrid tail (``birth="mh"``, the full-width block) and
the serial collapsed sweep (``birth="gibbs"``, a block of ``B`` columns
under ``k_live_buckets="on"``) run. The reference's hoisted (or chunked)
uniforms are drawn up front and passed in, one row of each per canonical
row, and read at absolute row indices.

Per row n, with A integrated out (Griffiths & Ghahramani):

    x_n | z_n, Z_-n, X_-n ~ N( z_n H_-,  sigma_x^2 (1 + z_n M_- z_n^T) I )

with M_- = (Z_-^T Z_- + (sx^2/sa^2) I)^{-1} and H_- = M_- Z_-^T X_-. The
factor (Lt = L^T, M, H) is carried across rows: removing a row is one
Sherman–Morrison move plus a rank-one Cholesky downdate, adding it back
one update; singleton drops and births are diagonal identity swaps. An
exact refactorization runs every ``refresh_every`` rows, and earlier when
the downdate loses positive definiteness or the drift probe (every
``PROBE_EVERY`` rows, ‖M W p − p‖∞ against the exact statistics) exceeds
``drift_tol``. New dishes are either the paper's MH move (j ~
Poisson(alpha/N), accepted with the marginal-likelihood ratio) or the
exact truncated Gibbs draw over j = 0..J_MAX, taken as the argmax of the
log posterior plus pre-drawn Gumbel noise, which is how
``jax.random.categorical`` draws it.

The block (``block_select``): every feature-indexed buffer (the mask,
ZᵀZ, ZᵀX, m and the factor) lives on ``B`` canonical columns ``cols``,
ascending: the live ones and the lowest-index free slots. Z and the
draws stay canonical and are gathered through ``cols`` row by row. A
birth draw sees the canonical free capacity (the out-of-block slots,
free by construction, count), and a birth that the block cannot place
where the canonical first-free-slot rule would (too few free slots in
the block, or one at or above ``min_out``) stops the scan BEFORE its row
is committed: ``ovf_row`` reports that row, the caller repacks at a
larger block and resumes there, and the draws, positional in the row,
repeat. At the full width (B = K) a birth cannot overflow.

Two flip flavors:

* ``"pallas"``: the mean-form recurrence (``collapsed_row_flip_ref``),
  O(K + D) a bit, no G. The reference's ``"pallas"``.
* ``"fast"``: the rss form (``collapsed_row_flip_fast``), O(K) a bit,
  with G = HHᵀ carried across rows: built at each exact factorization,
  moved by ``g_rank1`` at the removal and the add-back (reading the
  PRE-move H), masked at a drop and at the identity swaps of new slots;
  the drift probe adds the G-consistency term ‖G p − H(Hᵀp)‖∞ / (1 +
  max|G|). The reference's ``"fast"`` with ``carry_g=True``, with two
  savings: after a plain removal (no drop, no refresh) the flip's entry
  rss and rH are taken in closed form from the removal's b·b and H b
  (x − mean = −(1 + q) b there), where the reference recomputes them
  over D; and the add-back reads the flip's exit mean, z H1, which
  equals the reference's z2 H1 bit for bit.

The reference's ``lax.cond``s are Python ``if``s on flags read from the
tensors (``.tolist()``), so on a CUDA tensor each row waits on the device
twice; this version is the kernel's arithmetic spelled out, for the CPU
and for checking the kernel, not a path the sampler takes on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.collapsed_row import (
    collapsed_row_flip_fast,
    collapsed_row_flip_ref,
)
from repro_torch.linalg import (
    block_select,
    chol_inv,
    chol_rank1_downdate_t,
    chol_rank1_update_t,
    g_rank1,
    mask_outer,
    padded_W,
)

Tensor = torch.Tensor

J_MAX = 4  # per-row new-dish truncation (P(j>4 | alpha/N) is negligible)
PROBE_EVERY = 4  # drift-probe cadence within the refresh window
BIRTHS = ("mh", "gibbs")
FLAVORS = ("pallas", "fast")  # mean-form flip; rss flip with carried G
# log j! for j = 0..J_MAX, rounded to float32 (the kernel's table)
LOG_FACT = (0.0, 0.0, math.log(2.0), math.log(6.0), math.log(24.0))


def _log_poisson(j: Tensor, lam: Tensor) -> Tensor:
    """log Poisson(j; lam) for j = 0..J_MAX, float32, in the reference's
    order of terms; log j! from the table (the reference's float32
    lgamma is off the rounded value by up to 1e-6)."""
    log_fact = torch.tensor(LOG_FACT, dtype=j.dtype, device=j.device)
    return j * torch.log(lam) - lam - log_fact


def _sample_dishes(birth, draw, q, mean, x_n, active_m, z, sx, sa, lam, D,
                   n_free_extra=0.0):
    """The new-dish move: returns (z', active', newbits, j_new, sat).

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

    ``n_free_extra`` counts the free slots outside a packed block: the
    draw sees the canonical free capacity, while the new dishes go to the
    block's first free slots; the caller detects a birth the block could
    not place from ``j_new`` against ``newbits``.
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
    n_free = torch.sum(free) + n_free_extra
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
    return (z + newbits, torch.maximum(active_m, newbits), newbits, j_new,
            sat)


def _exact_factor(ZtZ, ZtX, active, ratio):
    """O(K^3 + K^2 D) exact (Lt, M, H) from the sufficient statistics."""
    L, M = chol_inv(padded_W(ZtZ, active, ratio))
    M = M * mask_outer(active)
    H = M @ (ZtX * active[:, None])
    return L.T, M, H


def gather_block(active: Tensor, ZtZ: Tensor, ZtX: Tensor, m: Tensor,
                 B: int) -> tuple[Tensor, Tensor, tuple[Tensor, ...]]:
    """The packed block of ``B`` columns: (cols, min_out, (active, ZtZ,
    ZtX, m) on the block), by index ops on the tensors' device with no
    host sync. At the full width (B = K) the canonical buffers
    themselves, so that the scan moves them in place, and min_out = K."""
    K = active.shape[0]
    if B == K:
        return (torch.arange(K, device=active.device), K,
                (active, ZtZ, ZtX, m))
    cols, min_out = block_select(active, B)
    return cols, min_out, (active[cols], ZtZ[cols][:, cols], ZtX[cols],
                           m[cols])


def scatter_block(cols: Tensor, block: tuple[Tensor, ...],
                  canon: tuple[Tensor, ...]) -> None:
    """Write the block's (active, ZtZ, ZtX, m) back into the canonical
    buffers in place; out-of-block slots are free, so their statistics
    are 0."""
    act, ZtZ, ZtX, m = canon
    for t in canon:
        t.zero_()
    act.index_copy_(0, cols, block[0])
    ZtZ[cols[:, None], cols[None, :]] = block[1]
    ZtX.index_copy_(0, cols, block[2])
    m.index_copy_(0, cols, block[3])


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
    flavor: str = "pallas",
    B: int | None = None,
    start_row: int = 0,
) -> Tensor:
    """Scan the collapsed row step over rows ``start_row``.. of ``X``, on
    the packed block of ``B`` columns (default: all K), with the flip
    ``flavor`` ("pallas" or "fast"). The block must hold every live
    column, ``B >= sum(active)`` (``block_select``).

    Births are MH moves from ``j_prop`` and ``log_u_acc``, or, when
    ``gumbel`` is given, Gibbs draws from it and ``alpha`` (the MH draws
    are then unused and may be None). ``N`` is the GLOBAL observation
    count: the tail runs on one shard's rows with global-N priors
    ((m_k - Z_nk)/N and Poisson(alpha/N)). Updates Z, active, ZtZ, ZtX
    and m in place and returns the int32 counts (n_refresh, n_sat,
    ovf_row): exact refactorizations and capacity-vetoed accepted MH
    births of the committed rows, and the row whose birth overflowed the
    block (not committed; -1 when the scan reached the last row).

    Chained (a leading chain axis C on Z, active, ZtZ, ZtX, m, X,
    u_logit, j_prop, log_u_acc, sx and sa, as the kernel's chained launch
    takes them): the single-chain scan chain by chain, counts (C, 3).
    """
    if Z.dim() == 3:
        if gumbel is not None:
            raise ValueError("a chained scan takes MH births")
        per_chain = (Z, active, ZtZ, ZtX, m, X, u_logit, j_prop, log_u_acc,
                     sx, sa)
        return torch.stack([collapsed_scan_ref(
            *(t[c] for t in per_chain), N=N, refresh_every=refresh_every,
            drift_tol=drift_tol, gumbel=gumbel, alpha=alpha, flavor=flavor,
            B=B, start_row=start_row) for c in range(Z.shape[0])])
    if flavor not in FLAVORS:
        raise ValueError(f"flavor={flavor!r} not in {FLAVORS}")
    n_rows, D = X.shape
    K_can = Z.shape[1]
    B = K_can if B is None else B
    dev, dt = X.device, X.dtype
    birth = "mh" if gumbel is None else "gibbs"
    fast = flavor == "fast"
    lam = None if alpha is None else alpha / N
    ratio = (sx / sa) ** 2
    inv2s2 = 0.5 / (sx**2)
    N_t = torch.tensor(N, dtype=dt, device=dev)
    n_out_free = float(K_can - B)  # out-of-block slots are free
    canon = (active, ZtZ, ZtX, m)
    cols, min_out, block = gather_block(*canon, B)
    active, ZtZ, ZtX, m = (t.clone() for t in block)
    cols_l = cols.tolist()
    min_out = int(min_out)
    Lt, M, H = _exact_factor(ZtZ, ZtX, active, ratio)
    G = H @ H.T if fast else None
    since = n_refresh = n_sat = 0
    ovf_row = -1

    for n in range(start_row, n_rows):
        x_n = X[n]
        z_old = Z[n, cols]
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
        # G moves with H, from the pre-move H
        if fast:
            hv, bb = H @ b_rm, torch.dot(b_rm, b_rm)
            G1 = g_rank1(G, H, wd, b_rm, hb=hv, bb=bb) * keep2
        flags = [torch.all(1.0 - torch.cumsum(p_down * p_down, 0) > 1e-12),
                 torch.any(drop > 0.5)]
        probe = since % PROBE_EVERY == 0
        if probe:  # drift probe: ‖M W p − p‖∞ against the exact statistics
            tm = ZtZ @ active_m - z_old * torch.dot(z_old, active_m)
            probe_t = active_m * tm + ratio * active_m
            drift = torch.max(torch.abs(M1 @ probe_t - active_m))
            if fast:  # and the carried G's consistency with H
                d_g = torch.max(torch.abs(G1 @ active_m
                                          - H1 @ (active_m @ H1)))
                drift = torch.maximum(
                    drift, d_g / (1.0 + torch.max(torch.abs(G1))))
            flags.append(drift <= drift_tol)
        flags = torch.stack(flags).tolist()
        down_ok, has_drop = flags[0], flags[1]
        need = (since >= refresh_every - 1 or not down_ok
                or (probe and not flags[2]))

        if need:  # exact refresh from the row-removed statistics
            Lt_rm, M1, H1 = _exact_factor(ZtZ - torch.outer(z_old, z_old),
                                          ZtX - torch.outer(z_old, x_n),
                                          active_m, ratio)
            if fast:
                G1 = H1 @ H1.T

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
        u = u_logit[n, cols]
        if fast:
            # after a plain removal x − mean = −(1 + q) b_rm, so rss and
            # rH = H1 (x − mean) follow from b_rm·b_rm and H b_rm
            rss_rH = None
            if not (has_drop or need):
                s1 = 1.0 + q
                rss_rH = (s1 * s1 * bb, -s1 * (active_m * (hv + bb * wd)))
            z, v, q, mean = collapsed_row_flip_fast(
                M1, H1, x_n, z, v, q, mean, u, m_minus, active_m, N_t,
                inv2s2, G=G1, rss_rH=rss_rH)
        else:
            z, v, q, mean = collapsed_row_flip_ref(
                M1, H1, x_n, z, v, q, mean, u, m_minus, active_m, N_t,
                inv2s2)

        # ---- new dishes: the canonical free capacity; a birth the block
        # cannot place where the canonical rule would stops the scan
        draw = gumbel[n] if birth == "gibbs" else (j_prop[n], log_u_acc[n])
        z2, active_new, newbits, j_new, sat = _sample_dishes(
            birth, draw, q, mean, x_n, active_m, z, sx, sa, lam, D,
            n_free_extra=n_out_free)
        flags = torch.stack([torch.any(z2 != z_old),
                             torch.any(active_new != active),
                             torch.sum(newbits) < j_new,
                             sat]).tolist()
        born = [cols_l[i] for i in torch.nonzero(newbits > 0.5).flatten()
                .tolist()]
        if flags[2] or (born and born[-1] >= min_out):
            ovf_row = n
            break
        changed = need or flags[0] or flags[1]
        since = 0 if need else since + 1
        n_refresh += int(need)
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
            if has_drop or born:  # identity swaps of dropped/born slots
                Lt1 = Lt1 * keep2 + torch.diag(1.0 - active_m)
                Lt1 = Lt1 + torch.diag(newbits * (torch.sqrt(ratio) - 1.0))
                M1 = M1 + torch.diag(newbits / ratio)
                H1 = H1 * (1.0 - newbits)[:, None]
                if fast:
                    G1 = G1 * mask_outer(1.0 - newbits)
            w2 = M1 @ z2
            Lt = chol_rank1_update_t(Lt1, Lt1 @ w2)
            d2 = 1.0 + torch.dot(z2, w2)
            w2r = w2 / torch.sqrt(d2)
            # the rss flip's exit mean is z H1, and the rows of H1 at
            # new bits are 0, so it equals z2 H1 bit for bit
            b_add = x_n - (mean if fast else z2 @ H1)
            M = M1 - torch.outer(w2r, w2r)
            if fast:
                G = g_rank1(G1, H1, w2 / d2, b_add)
            H = H1 + torch.outer(w2 / d2, b_add)

        Z[n, cols] = z2
        active = active_new
        m = m_minus * active_m + z2
    if B == K_can:
        for buf, val in zip(canon, (active, ZtZ, ZtX, m)):
            buf.copy_(val)
    else:
        scatter_block(cols, (active, ZtZ, ZtX, m), canon)
    return torch.tensor([n_refresh, n_sat, ovf_row], dtype=torch.int32,
                        device=dev)
