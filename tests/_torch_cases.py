"""Inputs and decision checks shared by the port's kernel tests.

No JAX here: tests/test_torch_cuda.py runs on the GPU machine, which
has no JAX.
"""
import math

import numpy as np
import torch

SHAPES = [(16, 8, 4), (100, 36, 16), (257, 64, 8), (64, 128, 32), (33, 20, 5)]


def _inputs(N, D, K, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Z = (rng.random((N, K)) < 0.3).astype(np.float32)
    A = rng.standard_normal((K, D)).astype(np.float32)
    act = (rng.random(K) < 0.8).astype(np.float32)
    return X, Z, A, act, rng


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def gibbs_planted_case(N, D, K, n_active=40, k_true=24, seed=0):
    """Sweep inputs with real cancellation, as chip_smoke's gibbs_flip
    check makes them: X = Z_true A_true + 0.5 noise (k_true N(0,1)
    features, Bernoulli(0.3) Z_true), A = 0.3 N(0,1) with its first
    k_true rows near A_true, the first n_active columns active and
    Bernoulli(0.3) on them, logit(pi) and u logit-uniforms, inv2s2 = 2
    (sigma 0.5). Returns X, Z, A, lpi, act, u, inv2s2."""
    rng = np.random.default_rng(seed)
    A_true = rng.standard_normal((k_true, D)).astype(np.float32)
    Zt = (rng.random((N, k_true)) < 0.3).astype(np.float32)
    X = (Zt @ A_true + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    A = (0.3 * rng.standard_normal((K, D))).astype(np.float32)
    A[:k_true] = A_true + 0.05 * rng.standard_normal((k_true, D))
    act = (np.arange(K) < n_active).astype(np.float32)
    Z = ((rng.random((N, K)) < 0.3) * act).astype(np.float32)

    def logit(p):
        p = np.clip(p, 1e-6, 1 - 1e-6)
        return (np.log(p) - np.log1p(-p)).astype(np.float32)

    return (X, Z, A, logit(rng.random(K)), act, logit(rng.random((N, K))),
            np.float32(2.0))


def gibbs_margin(X, Z_in, Z_out, A, lpi, inv2s2, u, n, k):
    """|logit - u| of decision (n, k) in float64, with bits < k taken from
    the output row and bits > k from the input row."""
    z = np.concatenate([Z_out[n, :k], [0.0], Z_in[n, k + 1:]]).astype(
        np.float64)
    A64 = A.astype(np.float64)
    r = X[n].astype(np.float64) - z @ A64
    logit = lpi[k] + (2.0 * r @ A64[k] - A64[k] @ A64[k]) * inv2s2
    return abs(logit - u[n, k])


def assert_decisions_match(got, want, margin_of, rel=1e-4, budget=1):
    """Decisions equal except ``budget`` first-in-row float-boundary
    events (|logit - u| < rel (1 + |u|))."""
    diff = np.argwhere(got != want)
    rows = sorted({int(n) for n, _ in diff})
    assert len(rows) <= budget, f"{len(diff)} decisions differ in rows {rows}"
    for n in rows:
        k = int(diff[diff[:, 0] == n][:, 1].min())
        m, u = margin_of(n, k)
        assert m < rel * (1.0 + abs(u)), (n, k, m, u)


def _collapsed_row_inputs(K, D, seed=0, frac_active=1.0):
    rng = np.random.default_rng(seed)
    act = (rng.random(K) < frac_active).astype(np.float32)
    if act.sum() == 0:
        act[0] = 1.0
    Zb = ((rng.random((5 * K, K)) < 0.3) * act).astype(np.float32)
    W = Zb.T @ Zb + 0.7 * np.diag(act) + np.diag(1 - act)
    M = (np.linalg.inv(W) * np.outer(act, act)).astype(np.float32)
    H = (M @ (Zb.T @ rng.standard_normal((5 * K, D)))).astype(np.float32)
    x = rng.standard_normal(D).astype(np.float32)
    z = ((rng.random(K) < 0.4) * act).astype(np.float32)
    v = (M @ z).astype(np.float32)
    q = np.float32(z @ v)
    mean = (z @ H).astype(np.float32)
    u = (rng.standard_normal(K) * 2).astype(np.float32)
    mm = Zb.sum(0).astype(np.float32)
    return [M, H, x, z, v, q, mean, u, mm, act, np.float32(8 * K),
            np.float32(0.5)]


def collapsed_row_margin(args, z_out, k):
    """|logodds - u| of bit k in float64, bits < k from the output."""
    M, H, x, z, v, q, mean, u, mm, act, N, inv2s2 = (
        np.asarray(a, np.float64) for a in args)
    D = x.shape[0]

    def ll(zz):
        s = 1.0 + zz @ M @ zz
        r = x - zz @ H
        return -0.5 * D * np.log(s) - inv2s2 * (r @ r) / s

    zz = np.concatenate([z_out[:k], [0.0], z[k + 1:]])
    z1 = zz.copy()
    z1[k] = 1.0
    lo = np.log(max(mm[k], 1e-20)) - np.log(N - mm[k]) + ll(z1) - ll(zz)
    return abs(lo - u[k]), u[k]


def scan_case(n_rows, K, D, seed=0, lam=0.1, alpha=None):
    """Inputs of one scan, made with numpy, float32.

    The rows are a planted linear-Gaussian matrix: a third of the K slots
    hold live features, two more features are in X but not in Z, so MH
    births are accepted where those rows propose one (j ~ Poisson(lam)),
    and one slot holds a singleton, dropped when its row is scanned. With
    ``alpha`` the case is the serial sweep's, with Gibbs births: it adds
    ``alpha`` and standard Gumbel noise ``gumbel`` (n_rows, 5), and those
    rows take their new dishes by the Gibbs draw instead."""
    rng = np.random.default_rng(seed)
    k_live = max(1, K // 3)
    A = rng.standard_normal((k_live + 2, D))
    Zt = (rng.random((n_rows, k_live + 2)) < 0.25).astype(np.float64)
    X = (Zt @ A + 0.5 * rng.standard_normal((n_rows, D))).astype(np.float32)
    Z = np.zeros((n_rows, K), np.float32)
    Z[:, :k_live] = Zt[:, :k_live]
    if K > k_live:
        Z[n_rows // 3, k_live] = 1.0
    act = (Z.sum(0) > 0).astype(np.float32)
    uu = np.clip(rng.random((n_rows, K)), 1e-7, 1.0 - 1e-7)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    case = dict(Z=Z, active=act, ZtZ=f32(Z.T @ Z), ZtX=f32(Z.T @ X),
                m=f32(Z.sum(0)), X=X, u_logit=f32(np.log(uu) - np.log1p(-uu)),
                j_prop=f32(rng.poisson(lam, n_rows)),
                log_u_acc=f32(np.log(rng.random(n_rows))))
    if alpha is not None:
        case.update(gumbel=f32(rng.gumbel(size=(n_rows, 5))),
                    alpha=np.float32(alpha))
    return case


def scan_divergence(case, Z_plain, Z_kernel, state_at, sx, sa, N,
                    rest=None):
    """Where two scans of ``case`` first decide differently: (row, what,
    margin, u). ``what`` is the bit k whose flip differs (margin |logodds -
    u|) or "birth": for the MH move the margin is |dll - log u_acc|, for
    the Gibbs draw the gap between the two largest of log Poisson(j) +
    ll_j + g_j, with u a hundredth of the largest |ll_j| (float32 carries
    the log-likelihoods' rounding into that gap). The margin is computed
    in float64 from the statistics entering the row; ``state_at(n)``
    gives (active, m) there, from the plain scan. ``rest`` = (ZᵀZ, ZᵀX)
    of rows outside the case, when the case is a prefix of a larger
    scan whose statistics count every row."""
    diff = np.argwhere(np.any(Z_plain != Z_kernel, axis=1))
    if len(diff) == 0:
        return None
    n = int(diff[0, 0])
    act, m = (np.asarray(a, np.float64) for a in state_at(n))
    X = case["X"].astype(np.float64)
    Zs = np.concatenate([Z_plain[:n], case["Z"][n:]]).astype(np.float64)
    D = X.shape[1]
    z_old = Zs[n]
    m_minus = m - z_old
    drop = act * (m_minus <= 0.5)
    act_m = act * (1.0 - drop)
    keep = np.arange(len(Zs)) != n
    Zm, Xm = Zs[keep] * act_m, X[keep]
    ratio = (sx / sa) ** 2
    ZtZ, ZtX = Zm.T @ Zm, Zm.T @ Xm
    if rest is not None:
        ZtZ = ZtZ + rest[0] * np.outer(act_m, act_m)
        ZtX = ZtX + rest[1] * act_m[:, None]
    W = ZtZ + ratio * np.diag(act_m) + np.diag(1.0 - act_m)
    M = np.linalg.inv(W) * np.outer(act_m, act_m)
    H = M @ ZtX
    x, inv2s2 = X[n], 0.5 / sx**2

    def ll(zz, extra=0.0):
        s = 1.0 + zz @ M @ zz + extra
        r = x - zz @ H
        return -0.5 * D * np.log(s) - inv2s2 * (r @ r) / s

    zz = z_old * (1.0 - drop)
    u = case["u_logit"][n]
    for k in range(len(zz)):
        if not (act_m[k] > 0 and m_minus[k] > 0.5):
            continue
        z0, z1 = zz.copy(), zz.copy()
        z0[k], z1[k] = 0.0, 1.0
        lo = np.log(max(m_minus[k], 1e-20)) - np.log(N - m_minus[k]) \
            + ll(z1) - ll(z0)
        if Z_plain[n, k] != Z_kernel[n, k]:
            return n, k, abs(lo - u[k]), u[k]
        zz[k] = Z_plain[n, k]
    if "gumbel" in case:
        n_free = np.sum(1.0 - np.maximum(act_m, zz))
        lam = float(case["alpha"]) / N
        lls = [ll(zz, j * (sa / sx) ** 2) for j in range(5)]
        vals = sorted((j * np.log(lam) - lam - math.lgamma(j + 1.0)
                       + lls[j] + float(case["gumbel"][n, j]))
                      for j in range(5) if j <= n_free)
        gap = vals[-1] - vals[-2] if len(vals) > 1 else math.inf
        return n, "birth", gap, max(abs(v) for v in lls) / 100.0
    j = min(float(case["j_prop"][n]), 4.0)
    dll = ll(zz, j * (sa / sx) ** 2) - ll(zz)
    lu = case["log_u_acc"][n]
    return n, "birth", abs(dll - lu), lu


def packed_scan_case(n_rows, K_can, D, width, seed=0, lam=0.1, alpha=None):
    """``scan_case`` at ``width`` columns spread over ``K_can`` canonical
    ones (at sorted random indices), with canonical uniforms: the input
    of a scan on a packed block of those columns and the rest free."""
    case = scan_case(n_rows, width, D, seed=seed, lam=lam, alpha=alpha)
    rng = np.random.default_rng(seed + 1)
    at = np.sort(rng.choice(K_can, size=width, replace=False))
    Z = np.zeros((n_rows, K_can), np.float32)
    Z[:, at] = case["Z"]
    uu = np.clip(rng.random((n_rows, K_can)), 1e-7, 1.0 - 1e-7)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    case.update(Z=Z, active=(Z.sum(0) > 0).astype(np.float32),
                ZtZ=f32(Z.T @ Z), ZtX=f32(Z.T @ case["X"]), m=f32(Z.sum(0)),
                u_logit=f32(np.log(uu) - np.log1p(-uu)))
    return case


def bank_samples(K_max, lives, D, sigma_x=0.6, seed=0, scale=1.0):
    """Posterior samples for a ``BankBuilder`` (either package's): one
    dict of ``add`` arguments per entry of ``lives``, that many live
    features in the leading slots, A = ``scale`` N(0,1) on them, pi
    uniform in [0.2, 0.8], chains alternating 0/1, it = 10, 11, ..."""
    rng = np.random.default_rng(seed)
    out = []
    for s, kl in enumerate(lives):
        act = np.zeros(K_max, np.float32)
        act[:kl] = 1.0
        A = (scale * rng.standard_normal((K_max, D))).astype(np.float32)
        out.append(dict(A=A * act[:, None],
                        pi=rng.uniform(0.2, 0.8, K_max).astype(np.float32)
                        * act, active=act, sigma_x=sigma_x, sigma_a=1.0,
                        alpha=2.0, chain=s % 2, it=10 + s))
    return out


def encode_row_margin(A, pi, active, sigma_x, chol, x, m, u, n_sweeps):
    """The float-boundary margin of one row's Gibbs chain under one bank
    sample, replayed in float64 along its own decisions: the smallest of
    |y_k - 1/2| over the warm start's live bits and |logit - u| over the
    live bit steps (``u`` the row's (n_sweeps, K) uniforms, ``m`` its
    mask or None). Two float32 runs of the scorer whose logits err by
    less than this margin make the same decisions."""
    f = lambda a: np.asarray(a, np.float64)  # noqa: E731
    A, pi, act, L, x = f(A), f(pi), f(active), f(chol), f(x)
    m = np.ones_like(x) if m is None else f(m)
    live = act > 0.5
    Am = A * act[:, None]
    y = np.linalg.solve(L @ L.T, Am @ (x * m))
    margin = float(np.min(np.abs(y[live] - 0.5), initial=np.inf))
    z = ((y > 0.5) & live).astype(np.float64)
    r = (x * m - z @ Am) * m
    an = (A * A) @ m
    logit = lambda p: np.log(p) - np.log1p(-p)  # noqa: E731
    lpi = logit(np.clip(pi, 1e-6, 1 - 1e-6))
    ul = logit(np.clip(f(u), 1e-6, 1 - 1e-6))
    inv2s2 = 0.5 / float(sigma_x) ** 2
    for s in range(n_sweeps):
        for k in np.flatnonzero(live):
            lg = lpi[k] + (2.0 * (r @ A[k] + z[k] * an[k]) - an[k]) * inv2s2
            margin = min(margin, abs(lg - ul[s, k]))
            znew = float(lg > ul[s, k])
            r -= (znew - z[k]) * A[k] * m
            z[k] = znew
    return margin


def scorer_divergence(bank, X, mask, u, n_sweeps, Z_a, Z_b, tol=1e-4):
    """Hold two runs of the batched scorer on the same inputs (``bank``
    fields, X, mask and u as numpy arrays; Z_a, Z_b (S, B, K) their
    draws): rows are independent chains, so each (sample, row) whose
    draws differ must have a float-boundary event (``encode_row_margin``
    < ``tol``) on its chain. Returns the differing (s, b, margin) and the
    count of differing bits; raises on a difference away from the
    boundary."""
    diff = np.argwhere(np.any(Z_a != Z_b, axis=-1))
    events = []
    for s, b in diff:
        mg = encode_row_margin(
            bank["A"][s], bank["pi"][s], bank["active"][s],
            bank["sigma_x"][s], bank["chol_f"][s], X[b],
            None if mask is None else mask[b], u[s, :, :, b], n_sweeps)
        if not mg < tol:
            raise AssertionError(f"scorer: sample {s} row {b} differs "
                                 f"away from a float boundary (margin "
                                 f"{mg})")
        events.append((int(s), int(b), mg))
    return events, int((Z_a != Z_b).sum())
