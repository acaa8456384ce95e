"""The plain reference: the sampler's stages.

Plain PyTorch, in float64 by default, importing nothing of
``repro_torch``. It draws the program's random numbers from the program's
keys (``keys.py``, a frozen copy of its key handling) and follows one
step from a state the program held, stage by stage:

* the uncollapsed sweeps (every row, the live columns, the sweep's
  logit-uniforms; the tail of the hybrid iteration writes only its own
  columns, so it does not touch these);
* the master sync from the Z that the step produced: the statistics, the
  draws of A, π, σ_x, σ_a, α and the next p′;
* the eval record's held-out and training joint log-likelihoods.

``prec="tf32"`` computes the same in float32 with every matrix product's
inputs, and each factorization's result, rounded to TF32 (10 mantissa
bits): the control, the precision a later change could be tempted by.
"""
from __future__ import annotations

import math

import torch

from . import keys

Tensor = torch.Tensor
LOG2PI = math.log(2.0 * math.pi)
PRECS = ("f64", "tf32")


def dtype_of(prec: str) -> torch.dtype:
    if prec not in PRECS:
        raise ValueError(f"prec={prec!r} not in {PRECS}")
    return torch.float64 if prec == "f64" else torch.float32


def tf32(x: Tensor) -> Tensor:
    """float32 rounded to the nearest TF32 value (ties away from 0)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: Tensor, b: Tensor, prec: str) -> Tensor:
    if prec == "f64":
        return a.double() @ b.double()
    return tf32(a) @ tf32(b)


def logit(p: Tensor, eps: float, dt: torch.dtype) -> Tensor:
    p = torch.clamp(p.to(dt), eps, 1.0 - eps)
    return torch.log(p) - torch.log1p(-p)


# --------------------------------------------------------------------------
# the uncollapsed Gibbs sweep
# --------------------------------------------------------------------------


def sweeps(X: Tensor, Z: Tensor, A: Tensor, pi: Tensor, active: Tensor,
           sigma_x: Tensor, uniforms: list[Tensor], prec: str = "f64"
           ) -> Tensor:
    """One Gibbs sweep of Z | π, A over the live columns, in column order,
    per entry of ``uniforms`` (each (N, K), float32 in (0, 1)):
    P(z_nk = 1 | rest) ∝ π_k N(x_n | z_n A, σ_x² I), accepted where the
    log-odds exceed logit(u_nk). Gram form: s_nk = x_n·a_k − Σ_j z_nj
    a_j·a_k + z_nk ‖a_k‖². Returns Z (float32)."""
    dt = dtype_of(prec)
    act = active > 0.5
    Am = A * act[:, None].to(A.dtype)
    P = mm(X, Am.T, prec).to(dt)
    G = mm(Am, Am.T, prec).to(dt)
    lpi = logit(pi, 1e-6, dt)
    inv2s2 = 0.5 / sigma_x.to(dt) ** 2
    Z = Z.to(dt).clone()
    live = torch.nonzero(act).flatten().tolist()
    for u in uniforms:
        ul = logit(u, 1e-6, dt)
        C = Z @ G
        for k in live:
            zk = Z[:, k].clone()
            s0 = P[:, k] - C[:, k] + zk * G[k, k]
            lg = lpi[k] + (2.0 * s0 - G[k, k]) * inv2s2
            zn = (lg > ul[:, k]).to(dt)
            C.addr_(zn - zk, G[k])
            Z[:, k] = zn
    return Z.float()


def hybrid_uniforms(key: int, P: int, N_p: int, K: int, L: int, device
                    ) -> list[Tensor]:
    """The hybrid iteration's sweep uniforms: sub-iteration l, shard p
    draws (N_p, K) from split(fold_in(fold_in(key, p), l), 2)[0]."""
    out = []
    for l in range(L):
        out.append(torch.cat([
            torch.rand((N_p, K), generator=keys.generator(
                keys.split(keys.fold_in(keys.fold_in(key, p), l), 2)[0],
                device), dtype=torch.float32, device=device)
            for p in range(P)]))
    return out


def sweep_forced(X: Tensor, Z_in: Tensor, Z_out: Tensor, A: Tensor,
                 pi: Tensor, active: Tensor, sigma_x: Tensor, u: Tensor,
                 prec: str = "f64") -> Tensor:
    """The log-odds less the threshold, d_nk = logit P(z_nk = 1 | rest)
    − logit(u_nk), of every live decision of one sweep from ``Z_in``,
    each taken in the state the sweep was in: columns before k at the
    sweep's own result ``Z_out``, the others at ``Z_in``. The reference
    decides z_nk = 1 where d_nk > 0; NaN marks the columns not swept."""
    dt = dtype_of(prec)
    act = active > 0.5
    Am = A * act[:, None].to(A.dtype)
    P = mm(X, Am.T, prec).to(dt)
    G = mm(Am, Am.T, prec).to(dt)
    lpi = logit(pi, 1e-6, dt)
    inv2s2 = 0.5 / sigma_x.to(dt) ** 2
    ul = logit(u, 1e-6, dt)
    Zi, Zo = Z_in.to(dt), Z_out.to(dt)
    C = Zi @ G
    d = torch.full(Zi.shape, float("nan"), dtype=dt, device=X.device)
    for k in torch.nonzero(act).flatten().tolist():
        s0 = P[:, k] - C[:, k] + Zi[:, k] * G[k, k]
        d[:, k] = lpi[k] + (2.0 * s0 - G[k, k]) * inv2s2 - ul[:, k]
        C.addr_(Zo[:, k] - Zi[:, k], G[k])
    return d


def tail_forced(R: Tensor, Z_in: Tensor, Z_out: Tensor, sigma_x, sigma_a,
                N: float, u_logit: Tensor, j_prop: Tensor,
                log_u_acc: Tensor, prec: str = "f64"
                ) -> tuple[Tensor, Tensor, Tensor]:
    """One collapsed tail scan (A integrated out, MH births) over the
    rows of the residual R (n, D), each row's decisions taken in the state
    the scan was in: rows before it at their result ``Z_out``, the others
    at ``Z_in``, and within the row the bits before k at their result.

    Row n: remove it from the statistics (a column left without rows
    drops); flip each live bit with log-odds log m₋/(N − m₋) + ll(1) −
    ll(0), ll(z) = −D/2 log(1 + z M zᵀ) − ‖r − z H‖² / (2σ_x²(1 + z M
    zᵀ)), M = (Z₋ᵀZ₋ + (σ_x/σ_a)² I)⁻¹, H = M Z₋ᵀR₋; then propose j
    ~ Poisson(α/N) new dishes, accepted when j fits the free columns and
    log u < ll_j − ll_0 with s_j = 1 + q + j (σ_a/σ_x)², into the first
    j free columns.

    Returns (d_flip (n, K): log-odds less logit(u), NaN where the bit is
    not a decision; d_birth (n,): ll_j − ll_0 − log u where the proposal
    fits, NaN where it does not; births_ok (n,): whether the row's new
    columns are the first j free ones with j its proposal)."""
    dt = dtype_of(prec)
    dev = R.device
    n, K = Z_in.shape
    D = R.shape[1]
    Rd = (R.double() if prec == "f64" else tf32(R)).to(dt)
    Zi, Zo = Z_in.to(dt), Z_out.to(dt)
    sx, sa = sigma_x.to(dt), sigma_a.to(dt)
    ratio = (sx / sa) ** 2
    inv2s2 = 0.5 / sx**2
    zero = torch.zeros((1, K), dtype=dt, device=dev)
    # statistics of the rows as they stood before row n
    pre_o = torch.cat([zero, torch.cumsum(Zo, 0)[:-1]])
    suf_i = torch.flip(torch.cumsum(torch.flip(Zi, [0]), 0), [0])
    m = pre_o + suf_i
    oo = Zo[:, :, None] * Zo[:, None, :]
    ii = Zi[:, :, None] * Zi[:, None, :]
    zk = torch.zeros((1, K, K), dtype=dt, device=dev)
    ZtZ = (torch.cat([zk, torch.cumsum(oo, 0)[:-1]])
           + torch.flip(torch.cumsum(torch.flip(ii, [0]), 0), [0]))
    del oo, ii
    oR = Zo[:, :, None] * Rd[:, None, :]
    iR = Zi[:, :, None] * Rd[:, None, :]
    zD = torch.zeros((1, K, D), dtype=dt, device=dev)
    ZtR = (torch.cat([zD, torch.cumsum(oR, 0)[:-1]])
           + torch.flip(torch.cumsum(torch.flip(iR, [0]), 0), [0]))
    del oR, iR
    # remove row n
    m_minus = m - Zi
    live = (m > 0.5) & (m_minus > 0.5)
    a = live.to(dt)
    z_in = Zi * a
    ZtZ -= Zi[:, :, None] * Zi[:, None, :]
    ZtR -= Zi[:, :, None] * Rd[:, None, :]
    m2 = a[:, :, None] * a[:, None, :]
    eye = torch.eye(K, dtype=dt, device=dev)[None]
    W = ZtZ * m2 + ratio * eye * m2 + eye * (1.0 - a)[:, :, None]
    M = torch.linalg.inv(W) * m2
    H = mm(M, ZtR * a[:, :, None], prec).to(dt)       # (n, K, D)
    del ZtR
    Hr = mm(H, Rd[:, :, None], prec).to(dt)[:, :, 0]  # (n, K)
    GH = mm(H, H.transpose(1, 2), prec).to(dt)        # (n, K, K)
    rr = (Rd * Rd).sum(1)

    def ll(z):
        q = torch.einsum("nk,nkj,nj->n", z, M, z)
        rss = rr - 2.0 * (z * Hr).sum(1) + torch.einsum(
            "nk,nkj,nj->n", z, GH, z)
        return q, rss, -0.5 * D * torch.log(1.0 + q) - inv2s2 * rss / (1.0 + q)

    prior = (torch.log(torch.clamp(m_minus, min=1e-20))
             - torch.log(N - m_minus))
    ul = u_logit.to(dt)
    d_flip = torch.full((n, K), float("nan"), dtype=dt, device=dev)
    z = z_in.clone()
    zf = Zo * a  # the row's bits after its flips
    for k in range(K):
        z1, z0 = z.clone(), z.clone()
        z1[:, k], z0[:, k] = 1.0, 0.0
        d = prior[:, k] + ll(z1)[2] - ll(z0)[2] - ul[:, k]
        d_flip[:, k] = torch.where(live[:, k], d, float("nan"))
        z[:, k] = zf[:, k]
    q, rss, _ = ll(zf)
    js = torch.arange(5, dtype=dt, device=dev)
    s_j = (1.0 + q)[:, None] + js[None, :] * (sa / sx) ** 2
    ll_j = -0.5 * D * torch.log(s_j) - inv2s2 * rss[:, None] / s_j
    free = 1.0 - a
    n_free = free.sum(1)
    jp = j_prop.to(dt)
    fits = jp <= torch.clamp(n_free, max=4.0)
    j_idx = torch.clamp(jp, 0, 4).long()
    dll = ll_j.gather(1, j_idx[:, None])[:, 0] - ll_j[:, 0]
    d_birth = torch.where(fits & (jp > 0), dll - log_u_acc.to(dt),
                          float("nan"))
    born = Zo * free
    nb = born.sum(1)
    rank = torch.cumsum(free, 1) * free
    first = ((rank >= 1) & (rank <= nb[:, None])).to(dt)
    births_ok = ((born == first).all(1) & ((nb == 0) | (nb == jp))
                 & ((nb == 0) | fits))
    return d_flip, d_birth, births_ok


def tail_draws(key: int, p: int, l: int, n_rows: int, K: int, alpha,
               N: float, device) -> tuple[Tensor, Tensor, Tensor]:
    """The tail scan's draws of sub-iteration l on shard p: from
    split(fold_in(fold_in(key, p), l), 2)[1], (n_rows, K) logit-uniforms,
    n_rows Poisson(α/N) proposals and n_rows log-uniforms, in that
    order."""
    g = keys.generator(keys.split(keys.fold_in(keys.fold_in(key, p), l),
                                  2)[1], device)
    uu = torch.rand((n_rows, K), generator=g, dtype=torch.float32,
                    device=device)
    uu = torch.clamp(uu, 1e-7, 1.0 - 1e-7).double()
    u_logit = torch.log(uu) - torch.log1p(-uu)
    lam = (alpha.float() / N) * torch.ones((n_rows,), dtype=torch.float32,
                                           device=device)
    j_prop = torch.poisson(lam, generator=g)
    log_u = torch.log(torch.rand((n_rows,), generator=g, dtype=torch.float32,
                                 device=device))
    return u_logit, j_prop, log_u


# --------------------------------------------------------------------------
# conjugate draws
# --------------------------------------------------------------------------


def stats(X: Tensor, Z: Tensor, prec: str) -> tuple[Tensor, Tensor, Tensor]:
    """(m, ZᵀZ, ZᵀX) in the precision's dtype."""
    dt = dtype_of(prec)
    return Z.to(dt).sum(0), mm(Z.T, Z, prec).to(dt), mm(Z.T, X, prec).to(dt)


def a_draw(ZtZ: Tensor, ZtX: Tensor, act: Tensor, sigma_x, sigma_a,
           eps: Tensor, prec: str) -> Tensor:
    """A | Z, X: rows of the live block ~ N(W⁻¹ ZᵀX, σ_x² W⁻¹), W = ZᵀZ +
    (σ_x/σ_a)² I, drawn as mean + σ_x chol(W⁻¹) ε with the given ε."""
    dt = ZtZ.dtype
    K = ZtZ.shape[0]
    a = act.to(dt)
    m2 = a[:, None] * a[None, :]
    eye = torch.eye(K, dtype=dt, device=ZtZ.device)
    ratio = (sigma_x.to(dt) / sigma_a.to(dt)) ** 2
    W = ZtZ * m2 + ratio * eye * m2 + eye * (1.0 - a)
    # at TF32 each factor is rounded to TF32 before it is used, as a
    # factorization carried out in TF32 would leave it
    rnd = (lambda t: t) if prec == "f64" else tf32
    Lw = rnd(torch.linalg.cholesky(W))
    Li = rnd(torch.linalg.solve_triangular(Lw, eye, upper=False))
    M = mm(Li.T, Li, prec).to(dt) * m2
    mean = mm(M, ZtX * a[:, None], prec).to(dt) * a[:, None]
    Lm = rnd(torch.linalg.cholesky(M + eye * (1.0 - a)))
    return mean + sigma_x.to(dt) * (mm(Lm, eps.to(dt), prec).to(dt)
                                    * a[:, None])


def gamma(shape: Tensor, gen: torch.Generator) -> Tensor:
    """A standard Gamma draw of a float32 shape on its device."""
    return torch._standard_gamma(shape.float(), generator=gen)


def sse(X: Tensor, Z: Tensor, A: Tensor, active: Tensor, prec: str
        ) -> Tensor:
    R = X.to(dtype_of(prec)) - mm(Z * active[None, :], A, prec)
    return torch.sum(R * R)


def harmonic(N: int) -> float:
    return float(sum(1.0 / i for i in range(1, N + 1)))


def hybrid_sync(pre: dict, Z: Tensor, X: Tensor, hyp: dict, P: int,
                prec: str = "f64") -> dict:
    """The master sync of the hybrid iteration from the Z it produced
    (tails promoted, dead columns zero): the live mask, A, π, σ_x, σ_a,
    α, the next p′ and key, drawn from ``pre``'s key."""
    dev = X.device
    N, D = X.shape
    k = pre["key"]
    k_a, k_pi = keys.split(keys.fold_in(k, 101), 2)
    k_sx, k_sa, k_al, k_pp = keys.split(keys.fold_in(k, 202), 4)
    m, ZtZ, ZtX = stats(X, Z, prec)
    m32 = Z.sum(0)  # integral: the float32 counts the draws take
    act = (m > 0.5)
    K = Z.shape[1]
    eps = torch.randn((K, D), generator=keys.generator(k_a, dev),
                      dtype=torch.float32, device=dev)
    A = a_draw(ZtZ, ZtX, act, pre["sigma_x"], pre["sigma_a"], eps, prec)
    g = keys.generator(k_pi, dev)
    ga = gamma(torch.clamp(m32, min=1e-6), g)
    gb = gamma(1.0 + float(N) - m32, g)
    pi = (ga.double() / (ga.double() + gb.double())) * act
    A32 = A.float()
    actf = act.float()
    s = sse(X, Z, A32, actf, prec)
    shape_x = torch.tensor(hyp["a_sx"] + 0.5 * float(N) * D,
                           dtype=torch.float32, device=dev)
    sigma_x = torch.sqrt((hyp["b_sx"] + 0.5 * s.double())
                         / gamma(shape_x, keys.generator(k_sx, dev)).double())
    kp32 = torch.sum(actf)
    a_ss = torch.sum(A.double() ** 2 * act[:, None])
    ga_s = gamma(hyp["a_sa"] + 0.5 * kp32 * D, keys.generator(k_sa, dev))
    sigma_a = (torch.sqrt((hyp["b_sa"] + 0.5 * a_ss) / ga_s.double())
               if float(kp32) > 0 else pre["sigma_a"].double())
    alpha = (gamma(hyp["a_alpha"] + kp32, keys.generator(k_al, dev)).double()
             / (hyp["b_alpha"] + harmonic(N)))
    p_prime = int(torch.randint(0, P, (), generator=keys.generator(
        k_pp, "cpu"), dtype=torch.int32))
    return dict(active=actf, A=A, pi=pi, sigma_x=sigma_x, sigma_a=sigma_a,
                alpha=alpha, p_prime=p_prime, key=keys.fold_in(k, 7))


def uncollapsed_sync(pre: dict, Z: Tensor, X: Tensor, hyp: dict,
                     prec: str = "f64") -> dict:
    """The serial uncollapsed step's draws after its sweep (every column
    live): A, π ~ Beta(α/K + m, 1 + N − m), σ_x, σ_a over all K columns,
    α with K+ the columns of m > 0.5, from ``pre``'s key."""
    dev = X.device
    N, D = X.shape
    K = Z.shape[1]
    key, _, k_a, k_pi, k_sx, k_sa, k_al = keys.split(pre["key"], 7)
    m, ZtZ, ZtX = stats(X, Z, prec)
    m32 = Z.sum(0)
    act = torch.ones((K,), dtype=torch.bool, device=dev)
    eps = torch.randn((K, D), generator=keys.generator(k_a, dev),
                      dtype=torch.float32, device=dev)
    A = a_draw(ZtZ, ZtX, act, pre["sigma_x"], pre["sigma_a"], eps, prec)
    g = keys.generator(k_pi, dev)
    ga = gamma(pre["alpha"].float() / K + m32, g)
    gb = gamma(1.0 + float(N) - m32, g)
    pi = ga.double() / (ga.double() + gb.double())
    s = sse(X, Z, A.float(), act.float(), prec)
    shape_x = torch.tensor(hyp["a_sx"] + 0.5 * N * D, dtype=torch.float32,
                           device=dev)
    sigma_x = torch.sqrt((hyp["b_sx"] + 0.5 * s.double())
                         / gamma(shape_x, keys.generator(k_sx, dev)).double())
    shape_a = torch.tensor(hyp["a_sa"] + 0.5 * K * D, dtype=torch.float32,
                           device=dev)
    sigma_a = torch.sqrt((hyp["b_sa"] + 0.5 * torch.sum(A.double() ** 2))
                         / gamma(shape_a, keys.generator(k_sa, dev)).double())
    kp32 = torch.sum(m32 > 0.5).float()
    alpha = (gamma(hyp["a_alpha"] + kp32, keys.generator(k_al, dev)).double()
             / (hyp["b_alpha"] + harmonic(N)))
    return dict(active=act.float(), A=A, pi=pi, sigma_x=sigma_x,
                sigma_a=sigma_a, alpha=alpha, key=key)


# --------------------------------------------------------------------------
# the eval record's log-likelihoods
# --------------------------------------------------------------------------


def z_prior(Z: Tensor, pi: Tensor, active: Tensor, dt) -> Tensor:
    p = torch.clamp(pi.to(dt), 1e-6, 1.0 - 1e-6)
    Zd = Z.to(dt)
    ll = Zd * torch.log(p)[None, :] + (1.0 - Zd) * torch.log1p(-p)[None, :]
    return torch.sum(ll * active.to(dt)[None, :])


def joint_ll(X: Tensor, Z: Tensor, A: Tensor, pi: Tensor, active: Tensor,
             sigma_x: Tensor, prec: str = "f64") -> Tensor:
    """log N(X | (Z∘active) A, σ_x² I) + log P(Z | π) over live columns."""
    dt = dtype_of(prec)
    n = X.numel()
    sx = sigma_x.to(dt)
    return (-0.5 * n * LOG2PI - n * torch.log(sx)
            - 0.5 * sse(X, Z, A, active, prec).to(dt) / sx**2
            + z_prior(Z, pi, active, dt))


def heldout_ll(X: Tensor, A: Tensor, pi: Tensor, active: Tensor,
               sigma_x: Tensor, key: int, n_sweeps: int = 3,
               prec: str = "f64") -> Tensor:
    """The held-out joint log-likelihood of the eval record: Z imputed by
    ``n_sweeps`` sweeps from Z = 0, sweep l's uniforms from
    fold_in(key, l), then ``joint_ll``."""
    dev = X.device
    Z = torch.zeros((X.shape[0], A.shape[0]), dtype=torch.float32,
                    device=dev)
    for l in range(n_sweeps):
        u = torch.rand(Z.shape, generator=keys.generator(
            keys.fold_in(key, l), dev), dtype=torch.float32, device=dev)
        Z = sweeps(X, Z, A, pi, active, sigma_x, [u], prec)
    return joint_ll(X, Z, A, pi, active, sigma_x, prec)
