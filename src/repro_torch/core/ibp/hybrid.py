"""The paper's hybrid parallel MCMC sampler for the IBP, on one device.

Port of the single-device layout of ``repro/core/ibp/hybrid.py``
(``_hybrid_iteration_body``: P shards simulated on one device). One
global iteration (paper Sec. 3):

  for l = 1..L sub-iterations:
      every shard p:   uncollapsed Gibbs sweep of Z over the K+ instantiated
                       features given (pi, A)                  [data-parallel]
      shard p' only:   collapsed Gibbs on its local tail features (A*
                       integrated out, residual R = X_p - Z A as data,
                       global-N priors) + MH birth of K_new ~ Poisson(alpha/N)
                       per row
  master sync:
      promote p''s tail columns into free K+ slots
      (m, ZtZ, ZtX) -> deactivate dead columns, draw A | Z,X then
      pi_k ~ Beta(m_k, 1 + N - m_k)
      ||X - Z A||^2 -> sigma_x^2, then sigma_a^2, alpha ~ conjugates
      p' ~ Uniform{0..P-1}; clear tail

Where the port differs in form, not in algorithm:

* Rows are independent and A, pi are shared, so each sub-iteration sweeps
  the rows of ALL P shards in one ``gibbs_flip`` launch on (P·N_p, D);
  the reference vmaps the sweep over shards.
* The tail runs on p' only. The reference computes every shard's tail
  under vmap and keeps p''s (a ``lax.cond`` on the shard index).
* The sync's reductions are the ``feature_stats`` and ``gaussian_sse``
  kernels over all rows at once (the reference sums per-shard jnp
  reductions).
* ``key``, ``p_prime`` and ``it`` live on the host: they steer host
  control flow (which shard runs the tail, which generator draws what),
  and keeping them there means an iteration never waits on the device.
  p' is drawn from a CPU generator.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.kernels.feature_stats import feature_stats
from repro_torch.kernels.gaussian_sse import gaussian_sse

from . import math as ibm
from .collapsed import DEFAULT_REFRESH, collapsed_row_scan, draw_scan
from .sweeps import uncollapsed_sweep

Tensor = torch.Tensor

_ALL_SHARDS = 0xFFFFFFFF  # fold-in tag of the all-shard sweep (shards < P)


@dataclasses.dataclass
class HybridGlobal:
    """Replicated state: the master's parameters."""

    A: Tensor         # (K_max, D)
    pi: Tensor        # (K_max,)
    active: Tensor    # (K_max,)
    alpha: Tensor     # ()
    sigma_x: Tensor   # ()
    sigma_a: Tensor   # ()
    key: Tensor       # (2,) uint32, on the host (see prng)
    p_prime: Tensor   # () int32, on the host
    it: Tensor        # () int32, on the host
    overflow: Tensor  # () int32 — promoted-feature drops due to K_max capacity
    tail_sat: Tensor  # () int32 — tail rows whose accepted MH birth was
    #                   vetoed by K_tail capacity


@dataclasses.dataclass
class HybridShard:
    """Sharded along the observation axis. Leading axis = shard (size P)."""

    Z: Tensor            # (P, N_p, K_max)
    Z_tail: Tensor       # (P, N_p, K_tail)
    tail_active: Tensor  # (P, K_tail)


def _host_int(v: int) -> Tensor:
    return torch.tensor(v, dtype=torch.int32)


def init_hybrid(
    key: Tensor,
    X_shards: Tensor,  # (P, N_p, D)
    K_max: int,
    K_tail: int = 8,
    alpha: float = 3.0,
    sigma_x: float = 1.0,
    sigma_a: float = 1.0,
    K_init: int = 4,
    init_from_data: bool = True,
) -> tuple[HybridGlobal, HybridShard]:
    P_, N_p, D = X_shards.shape
    dev, dt = X_shards.device, X_shards.dtype
    K_init = min(K_init, K_max)
    k0, k1, k2 = prng.split(key, 3)
    Z = torch.zeros((P_, N_p, K_max), dtype=dt, device=dev)
    A = torch.zeros((K_max, D), dtype=dt, device=dev)
    if K_init > 0:
        Z[:, :, :K_init] = (torch.rand((P_, N_p, K_init),
                                       generator=prng.generator(k0, dev),
                                       dtype=dt, device=dev) < 0.5).to(dt)
        g1 = prng.generator(k1, dev)
        if init_from_data:
            # seed features with (noised) data rows spread across shards —
            # avoids the all-features-die nucleation trap at cold start
            flat = X_shards.reshape(-1, D)
            stride = max(1, flat.shape[0] // K_init)
            seeds = flat[::stride][:K_init]
            A[:K_init] = seeds + 0.1 * torch.randn(
                seeds.shape, generator=g1, dtype=dt, device=dev)
        else:
            A[:K_init] = torch.randn((K_init, D), generator=g1, dtype=dt,
                                     device=dev) * sigma_a
    active = torch.zeros((K_max,), dtype=dt, device=dev)
    active[:K_init] = 1.0
    pi = torch.zeros((K_max,), dtype=dt, device=dev)
    pi[:K_init] = 0.5
    scalar = lambda v: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    gs = HybridGlobal(
        A=A, pi=pi, active=active, alpha=scalar(alpha),
        sigma_x=scalar(sigma_x), sigma_a=scalar(sigma_a), key=k2,
        p_prime=_host_int(0), it=_host_int(0),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        tail_sat=torch.zeros((), dtype=torch.int32, device=dev),
    )
    ss = HybridShard(
        Z=Z,
        Z_tail=torch.zeros((P_, N_p, K_tail), dtype=dt, device=dev),
        tail_active=torch.zeros((P_, K_tail), dtype=dt, device=dev),
    )
    return gs, ss


def _tail_sub_iteration(
    X_p: Tensor,
    Z: Tensor,
    Z_tail: Tensor,
    tail_active: Tensor,
    gs: HybridGlobal,
    N_global: float,
    gen: torch.Generator,
    chol_refresh: int = DEFAULT_REFRESH,
    collapsed_backend: str = "fast",
) -> tuple[Tensor, Tensor, Tensor]:
    """Collapsed Gibbs + MH births on the tail of shard p'.

    ``collapsed_backend`` selects the row step: "fast" (the rss flip with
    the carried G) or "pallas" (the mean-form flip), each the carried
    scan, one ``collapsed_scan`` launch on the card; "ref" the O(K^3)
    oracle ``_row_step``. The tail runs its full K_tail width; the
    reference's ``k_live_pack`` switch has no counterpart, because the
    port carries G for "fast" either way (``collapsed`` module
    docstring). Returns (Z_tail, tail_active, n_sat): ``n_sat`` counts
    rows whose accepted MH birth was vetoed purely by K_tail capacity.
    """
    # residual given instantiated features = the tail model's data
    R = X_p - (Z * gs.active[None, :]) @ gs.A
    m_t = torch.sum(Z_tail, dim=0)
    ZtZ_t = Z_tail.T @ Z_tail
    ZtR = Z_tail.T @ R
    draws = draw_scan(R.shape[0], Z_tail.shape[1], gs.alpha, N_global, gen)
    Z_tail, tail_active, _, _, m_t, _, n_sat = collapsed_row_scan(
        Z_tail, tail_active, ZtZ_t, ZtR, m_t, R, gs.sigma_x, gs.sigma_a,
        draws, N=N_global, birth="mh", backend=collapsed_backend,
        refresh_every=chol_refresh,
    )
    # prune dead tail columns
    tail_active = tail_active * (m_t > 0.5)
    Z_tail = Z_tail * tail_active[None, :]
    return Z_tail, tail_active, n_sat


def shard_sub_iterations(
    X_shards: Tensor,
    Z: Tensor,
    Z_tail: Tensor,
    tail_active: Tensor,
    gs: HybridGlobal,
    N_global: float,
    L: int,
    chol_refresh: int = DEFAULT_REFRESH,
    collapsed_backend: str = "fast",
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """L sub-iterations of the paper's inner loop on all P shards.

    Each sub-iteration sweeps every shard's rows in one call, then runs
    the tail on p'. Returns (Z, Z_tail, tail_active, n_sat).
    """
    P_, N_p, D = X_shards.shape
    dev = X_shards.device
    pp = int(gs.p_prime)
    Xf = X_shards.reshape(P_ * N_p, D)
    Zf = Z.reshape(P_ * N_p, -1)
    Z_tail, tail_active = Z_tail.clone(), tail_active.clone()
    n_sat = torch.zeros((), dtype=torch.int32, device=dev)
    k_all = prng.fold_in(gs.key, _ALL_SHARDS)
    k_pp = prng.fold_in(gs.key, pp)
    for l in range(L):
        ku, _ = prng.split(prng.fold_in(k_all, l), 2)
        _, kt = prng.split(prng.fold_in(k_pp, l), 2)
        Zf = uncollapsed_sweep(Xf, Zf, gs.A, gs.pi, gs.active, gs.sigma_x,
                               prng.generator(ku, dev))
        Zt, ta, sat = _tail_sub_iteration(
            X_shards[pp], Zf.view(P_, N_p, -1)[pp], Z_tail[pp],
            tail_active[pp], gs, N_global, prng.generator(kt, dev),
            chol_refresh=chol_refresh, collapsed_backend=collapsed_backend,
        )
        Z_tail[pp] = Zt
        tail_active[pp] = ta
        n_sat = n_sat + sat
    return Zf.view(P_, N_p, -1), Z_tail, tail_active, n_sat


def promote_tail(
    Z: Tensor,              # (..., K_max)
    Z_tail: Tensor,         # (..., K_tail)
    tail_active_g: Tensor,  # (K_tail,)
    active: Tensor,         # (K_max,)
) -> tuple[Tensor, Tensor, Tensor]:
    """Scatter tail columns into free K+ slots.

    ``tail_active_g`` is the reduced tail mask (only p' contributes), so
    every shard gets the same slot assignment; shards other than p' add
    zero columns. Returns (Z_new, active_new, n_dropped).
    """
    K_max = Z.shape[-1]
    free = 1.0 - active
    n_free = torch.sum(free)
    rank = torch.cumsum(tail_active_g, 0) * tail_active_g  # 1-indexed
    kept = tail_active_g * (rank <= n_free)
    n_drop = torch.sum(tail_active_g) - torch.sum(kept)
    # target slot of tail j = index of the rank_j-th free slot
    cums = torch.cumsum(free, 0)
    tgt = torch.searchsorted(cums, torch.clamp(rank, min=1.0))
    tgt = torch.clamp(tgt, 0, K_max - 1)
    # an index repeats only for zero columns (kept = 0): adding zeros
    Z_new = Z.index_add(Z.dim() - 1, tgt, Z_tail * kept)
    active_new = active.scatter_reduce(0, tgt, kept, reduce="amax")
    return Z_new, active_new, n_drop.to(torch.int32)


def local_stats(X: Tensor, Z: Tensor) -> dict[str, Tensor]:
    """(m, ZtZ, ZtX) over all rows of X (..., D), Z (..., K)."""
    ZtZ, ZtX, m = feature_stats(X.reshape(-1, X.shape[-1]),
                                Z.reshape(-1, Z.shape[-1]))
    return {"m": m, "ZtZ": ZtZ, "ZtX": ZtX}


def local_sse(X: Tensor, Z: Tensor, A: Tensor, active: Tensor) -> Tensor:
    """||X - (Z*active) A||^2 over all rows."""
    return gaussian_sse(X.reshape(-1, X.shape[-1]),
                        Z.reshape(-1, Z.shape[-1]), A, active)


def master_step1(
    stats: dict[str, Tensor],
    active: Tensor,
    gs: HybridGlobal,
    N_global: float,
    D: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Deaths, A | Z,X draw, pi | Z draw."""
    dev = active.device
    k_a, k_pi = prng.split(prng.fold_in(gs.key, 101), 2)
    m = stats["m"] * active
    active = active * (m > 0.5)
    ZtZ = stats["ZtZ"] * ibm.mask_outer(active)
    ZtX = stats["ZtX"] * active[:, None]
    A = ibm.a_posterior_draw(prng.generator(k_a, dev), ZtZ, ZtX, active,
                             gs.sigma_x, gs.sigma_a)
    # pi_k | Z ~ Beta(m_k, 1 + N - m_k) for instantiated features
    pi = ibm.beta_draw(prng.generator(k_pi, dev), torch.clamp(m, min=1e-6),
                       1.0 + N_global - m) * active
    return A, pi, active, m


def master_step2(
    sse: Tensor,
    A: Tensor,
    active: Tensor,
    gs: HybridGlobal,
    hyp,
    N_global: float,
    D: int,
    P_: int,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """sigma_x, sigma_a, alpha, p'."""
    dev, dt = A.device, A.dtype
    k_sx, k_sa, k_al, k_pp = prng.split(prng.fold_in(gs.key, 202), 4)
    k_plus = torch.sum(active)
    if hyp.resample_sigmas:
        sx2 = ibm.inverse_gamma_draw(
            prng.generator(k_sx, dev),
            torch.tensor(hyp.a_sx + 0.5 * N_global * D, dtype=dt,
                         device=dev),
            hyp.b_sx + 0.5 * sse)
        sigma_x = torch.sqrt(sx2)
        a_ss = torch.sum(A * A * active[:, None])
        sa2 = ibm.inverse_gamma_draw(prng.generator(k_sa, dev),
                                     hyp.a_sa + 0.5 * k_plus * D,
                                     hyp.b_sa + 0.5 * a_ss)
        # with no live features the draw is pure heavy-tailed prior and can
        # wander into a region where births are impossible — hold it instead
        sigma_a = torch.where(k_plus > 0, torch.sqrt(sa2), gs.sigma_a)
    else:
        sigma_x, sigma_a = gs.sigma_x, gs.sigma_a
    if hyp.resample_alpha:
        HN = ibm.harmonic(int(N_global))
        alpha = ibm.gamma_draw(prng.generator(k_al, dev),
                               hyp.a_alpha + k_plus, hyp.b_alpha + HN)
    else:
        alpha = gs.alpha
    p_prime = torch.randint(0, P_, (), generator=prng.generator(k_pp, "cpu"),
                            dtype=torch.int32)
    return sigma_x, sigma_a, alpha, p_prime


def _hybrid_iteration_body(
    X_shards: Tensor,  # (P, N_p, D)
    gs: HybridGlobal,
    ss: HybridShard,
    hyp,
    L: int,
    N_g: float,
    chol_refresh: int = DEFAULT_REFRESH,
    collapsed_backend: str = "fast",
) -> tuple[HybridGlobal, HybridShard]:
    """One full hybrid iteration (sub-iterations + master sync)."""
    P_, N_p, D = X_shards.shape
    Z, Z_tail, tail_active, n_sat = shard_sub_iterations(
        X_shards, ss.Z, ss.Z_tail, ss.tail_active, gs, N_g, L,
        chol_refresh=chol_refresh, collapsed_backend=collapsed_backend,
    )
    # ---- master sync
    tail_g = torch.sum(tail_active, dim=0)  # only p' is nonzero
    Z, active_new, n_drop = promote_tail(Z, Z_tail, tail_g, gs.active)
    stats = local_stats(X_shards, Z)
    A, pi, active, _ = master_step1(stats, active_new, gs, N_g, D)
    Z = Z * active[None, None, :]
    sse = local_sse(X_shards, Z, A, active)
    sigma_x, sigma_a, alpha, p_prime = master_step2(
        sse, A, active, gs, hyp, N_g, D, P_
    )
    gs_new = HybridGlobal(
        A=A, pi=pi, active=active, alpha=alpha,
        sigma_x=sigma_x, sigma_a=sigma_a,
        key=prng.fold_in(gs.key, 7),
        p_prime=p_prime, it=gs.it + 1,
        overflow=gs.overflow + n_drop,
        tail_sat=gs.tail_sat + n_sat,
    )
    ss_new = HybridShard(
        Z=Z,
        Z_tail=torch.zeros_like(ss.Z_tail),
        tail_active=torch.zeros_like(ss.tail_active),
    )
    return gs_new, ss_new
