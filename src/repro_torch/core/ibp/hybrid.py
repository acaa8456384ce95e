"""The paper's hybrid parallel MCMC sampler for the IBP.

Port of ``repro/core/ibp/hybrid.py``: the single-device layouts
(``_hybrid_iteration_body``: P shards simulated on one device; with
chains="vmap", C independent chains: ``init_multichain``, the iteration
under ``jax.vmap``, and the bounded-staleness pass), and the distributed
layouts of ``_build_mesh_fns``, one process a device of the reference's
mesh (``parallel.Mesh``): data="shardmap" (one shard a process, the
master sync's reductions as all-reduces over the data axis, "staged" or
"fused"), and chains="mesh" (one chain a process row: C independent
copies of either data layout, no collective across the chain axis). One
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

* Rows are independent and A, pi are shared, so under vmap each
  sub-iteration sweeps the rows of ALL P shards in one ``gibbs_flip``
  launch on (P·N_p, D); the reference vmaps the sweep over shards. Each
  shard's uniforms come from its own key, as in the reference, so a
  shard draws the same numbers under either layout.
* The tail runs on p' only. The reference computes every shard's tail
  under vmap and keeps p''s (a ``lax.cond`` on the shard index).
* Under vmap the sync's reductions are the ``feature_stats`` and
  ``gaussian_sse`` kernels over all rows at once (the reference sums
  per-shard jnp reductions); under shardmap each rank runs them on its
  rows and ``parallel.all_reduce_sum`` sums them over its data group.
* ``key``, ``p_prime`` and ``it`` live on the host: they steer host
  control flow (which shard runs the tail, which generator draws what),
  and keeping them there means an iteration never waits on the device.
  p' is drawn from a CPU generator.
* Chains: the iteration is written chain-batched (every leaf with a
  leading chain axis C; keys (C, 2), p' and it (C,)); a chainless state
  runs as a chain of one. Each chain's sweeps, ``feature_stats`` and
  ``gaussian_sse`` are launches of their own (each chain has its own A,
  pi, active and sigma_x); each sub-iteration gathers every chain's tail
  rows from its own p' and runs the C tails as ONE chained
  ``collapsed_scan`` launch, C blocks on C SMs, then scatters them
  back. Chain c's keys are derived from its own key row, so chain c
  follows the single-chain iteration on its own state.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import parallel, prng, tracing
from repro_torch.kernels.feature_stats import feature_stats
from repro_torch.kernels.gaussian_sse import gaussian_sse

from . import math as ibm
from .collapsed import DEFAULT_REFRESH, collapsed_row_scan, draw_scan
from .sweeps import uncollapsed_sweep

Tensor = torch.Tensor

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


def chain_of(tree, c: int):
    """Chain c of a chain-batched HybridGlobal or HybridShard (views)."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name)[c] for f in dataclasses.fields(tree)})


def stack_chains(trees: list):
    """HybridGlobals (or HybridShards) of C chains -> one chain-batched
    state, every leaf stacked on a leading chain axis on its own device
    (the host fields stay on the host)."""
    return dataclasses.replace(trees[0], **{
        f.name: torch.stack([getattr(t, f.name) for t in trees])
        for f in dataclasses.fields(trees[0])})


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
    device: torch.device | None = None,
) -> tuple[HybridGlobal, HybridShard]:
    """The canonical start: every shard's Z (P, N_p, K_max), drawn on
    ``device`` (default X_shards' device: a shardmap rank passes its
    host copy of the data and its own device, and so draws the state the
    vmap layout draws on that device)."""
    P_, N_p, D = X_shards.shape
    dev = X_shards.device if device is None else device
    dt = X_shards.dtype
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
            seeds = flat[::stride][:K_init].to(dev)
            A[:K_init] = seeds + 0.1 * torch.randn(
                seeds.shape, generator=g1, dtype=dt, device=dev)
        else:
            A[:K_init] = torch.randn((K_init, D), generator=g1, dtype=dt,
                                     device=dev) * sigma_a
    active = torch.zeros((K_max,), dtype=dt, device=dev)
    active[:K_init] = 1.0
    pi = torch.zeros((K_max,), dtype=dt, device=dev)
    pi[:K_init] = 0.5
    with tracing.transfer("init", 3):
        alpha, sigma_x, sigma_a = (torch.tensor(v, dtype=dt, device=dev)
                                   for v in (alpha, sigma_x, sigma_a))
    gs = HybridGlobal(
        A=A, pi=pi, active=active, alpha=alpha,
        sigma_x=sigma_x, sigma_a=sigma_a, key=k2,
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


def init_multichain(
    key: Tensor,
    X_shards: Tensor,  # (P, N_p, D), shared by every chain
    C: int,
    K_max: int,
    **kw,
) -> tuple[HybridGlobal, HybridShard]:
    """C independent chains: every state leaf gains a leading chain axis.

    Chains share the data but start from ``prng.split(key, C)``, so chain
    c is ``init_hybrid`` from key c and the trajectories are independent,
    as split-R-hat needs."""
    outs = [init_hybrid(k, X_shards, K_max, **kw)
            for k in prng.split(key, C)]
    return (stack_chains([o[0] for o in outs]),
            stack_chains([o[1] for o in outs]))


def _chain_tails(
    X_p: Tensor,
    Z: Tensor,
    Z_tail: Tensor,
    tail_active: Tensor,
    gs: HybridGlobal,
    N_global: float,
    gens: list[torch.Generator],
    chol_refresh: int = DEFAULT_REFRESH,
    collapsed_backend: str = "fast",
) -> tuple[Tensor, Tensor, Tensor]:
    """Collapsed Gibbs + MH births on the tails of C chains, each on its
    own p′: X_p (C, N_p, D) and Z (C, N_p, K_max) the rows of each chain's
    p′, Z_tail (C, N_p, K_tail), tail_active (C, K_tail), ``gs``
    chain-batched, ``gens`` a generator a chain.

    ``collapsed_backend`` selects the row step: "fast" (the rss flip with
    the carried G) or "pallas" (the mean-form flip), each the carried
    scan, one ``collapsed_scan`` launch for all C chains on the card;
    "ref" the O(K^3) oracle ``_row_step``. The tail runs its full K_tail
    width; the reference's ``k_live_pack`` switch has no counterpart,
    because the port carries G for "fast" either way (``collapsed``
    module docstring). A chain's residual and statistics are computed on
    its own, as a single chain's would be. Returns (Z_tail, tail_active,
    n_sat): ``n_sat`` (C,) counts rows whose accepted MH birth was vetoed
    purely by K_tail capacity.
    """
    C = Z_tail.shape[0]
    # residual given instantiated features = the tail model's data
    R = torch.stack([X_p[c] - (Z[c] * gs.active[c][None, :]) @ gs.A[c]
                     for c in range(C)])
    m_t = torch.sum(Z_tail, dim=1)
    ZtZ_t = torch.stack([Z_tail[c].T @ Z_tail[c] for c in range(C)])
    ZtR = torch.stack([Z_tail[c].T @ R[c] for c in range(C)])
    draws = draw_scan(R.shape[1], Z_tail.shape[2], gs.alpha, N_global, gens)
    Z_tail, tail_active, _, _, m_t, _, n_sat = collapsed_row_scan(
        Z_tail, tail_active, ZtZ_t, ZtR, m_t, R, gs.sigma_x, gs.sigma_a,
        draws, N=N_global, birth="mh", backend=collapsed_backend,
        refresh_every=chol_refresh,
    )
    # prune dead tail columns
    tail_active = tail_active * (m_t > 0.5)
    Z_tail = Z_tail * tail_active[:, None, :]
    return Z_tail, tail_active, n_sat


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
    """``_chain_tails`` for one chain (chainless arguments): the tail of
    shard p′, one ``collapsed_scan`` launch on the card. Returns
    (Z_tail, tail_active, n_sat)."""
    out = _chain_tails(X_p[None], Z[None], Z_tail[None], tail_active[None],
                       stack_chains([gs]), N_global, [gen],
                       chol_refresh=chol_refresh,
                       collapsed_backend=collapsed_backend)
    return tuple(t[0] for t in out)


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
    shards: tuple[int, ...] | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """L sub-iterations of the paper's inner loop on the shards this
    process holds, for C chains: X_shards (S, N_p, D), Z (C, S, N_p,
    K_max), Z_tail (C, S, N_p, K_tail), tail_active (C, S, K_tail),
    ``gs`` chain-batched. ``shards`` gives the global index of each held
    shard: 0..P-1 under vmap (the default), the rank's data coordinate
    under shardmap.

    Shard p's keys are the reference's: ``key_shard = fold_in(key, p)``,
    then ``ku, kt = split(fold_in(key_shard, l))``; its sweep uniforms
    come from ``generator(ku)``, and the tail of p′ from
    ``generator(kt)``, so a shard draws the same numbers whichever
    process holds it. Each sub-iteration sweeps every held shard's rows
    of a chain in one ``gibbs_flip`` call (each chain has its own A, π,
    active and σ_x); then, where p′ is held, it gathers each chain's tail
    into (C, N_p, ·) buffers, runs the C tails as one chained scan and
    scatters them back. Returns (Z, Z_tail, tail_active, n_sat (C,)).
    """
    C = Z.shape[0]
    S, N_p, D = X_shards.shape
    shards = tuple(range(S)) if shards is None else tuple(shards)
    dev = X_shards.device
    Xf = X_shards.reshape(S * N_p, D)
    Zf = [Z[c].reshape(S * N_p, -1) for c in range(C)]
    Z_tail, tail_active = Z_tail.clone(), tail_active.clone()
    n_sat = torch.zeros((C,), dtype=torch.int32, device=dev)
    # local index of each chain's p′; every chain's p′ is held (vmap) or
    # none is (a shardmap rank other than the one chain's p′)
    pps = [shards.index(p) for p in gs.p_prime.tolist() if p in shards]
    k_shard = [[prng.fold_in(gs.key[c], p) for p in shards]
               for c in range(C)]
    for l in range(L):
        with tracing.span("sweep"):
            kl = [[prng.split(prng.fold_in(k, l), 2) for k in ks]
                  for ks in k_shard]
            for c in range(C):
                Zf[c] = uncollapsed_sweep(
                    Xf, Zf[c], gs.A[c], gs.pi[c], gs.active[c],
                    gs.sigma_x[c],
                    [prng.generator(ku, dev) for ku, _ in kl[c]])
        if not pps:
            continue
        with tracing.span("tail"):
            # gathered and scattered by host indices (views and copies on
            # the device), so no index tensor is copied to the device
            tail_in = (
                torch.stack([X_shards[i] for i in pps]),
                torch.stack([Zf[c].view(S, N_p, -1)[i]
                             for c, i in enumerate(pps)]),
                torch.stack([Z_tail[c, i] for c, i in enumerate(pps)]),
                torch.stack([tail_active[c, i] for c, i in enumerate(pps)]),
            )
            tail_keys = [kl[c][i][1] for c, i in enumerate(pps)]

            def tail(tail_in=tail_in, tail_keys=tail_keys):
                return _chain_tails(
                    *tail_in, gs, N_global,
                    [prng.generator(k, dev) for k in tail_keys],
                    chol_refresh=chol_refresh,
                    collapsed_backend=collapsed_backend)

            # _chain_tails modifies none of its inputs: a reader may run
            # it again (tracing.replay)
            tracing.replay("tail", tail)
            Zt, ta, sat = tail()
            for c, i in enumerate(pps):
                Z_tail[c, i] = Zt[c]
                tail_active[c, i] = ta[c]
            n_sat = n_sat + sat
    return (torch.stack([z.view(S, N_p, -1) for z in Zf]), Z_tail,
            tail_active, n_sat)


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
        with tracing.transfer("sigma_x_shape"):
            shape = torch.tensor(hyp.a_sx + 0.5 * N_global * D, dtype=dt,
                                 device=dev)
        sx2 = ibm.inverse_gamma_draw(prng.generator(k_sx, dev), shape,
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

def _finish_sync(
    gs: HybridGlobal,
    Z: Tensor,
    Z_tail: Tensor,
    tail_active: Tensor,
    A: Tensor,
    pi: Tensor,
    active: Tensor,
    sse: Tensor,
    n_drop: Tensor,
    n_sat: Tensor,
    hyp,
    N_g: float,
    P_: int,
) -> tuple[HybridGlobal, HybridShard]:
    """The sync's last step, the same in every layout: σ, α and the next
    p′ (``master_step2``), the new HybridGlobal, and the shards with
    their tails cleared."""
    sigma_x, sigma_a, alpha, p_prime = master_step2(
        sse, A, active, gs, hyp, N_g, A.shape[1], P_
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
        Z_tail=torch.zeros_like(Z_tail),
        tail_active=torch.zeros_like(tail_active),
    )
    return gs_new, ss_new


def _master_sync(
    X_shards: Tensor,
    gs: HybridGlobal,
    Z: Tensor,
    Z_tail: Tensor,
    tail_active: Tensor,
    n_sat: Tensor,
    hyp,
    N_g: float,
) -> tuple[HybridGlobal, HybridShard]:
    """One chain's master sync after its sub-iterations on all P shards
    of one device (chainless arguments): promote p′'s tail, the
    statistics, A and π, the SSE, σ, α and the next p′; the tails are
    cleared."""
    P_, N_p, D = X_shards.shape
    with tracing.span("sync"):
        tail_g = torch.sum(tail_active, dim=0)  # only p' is nonzero
        Z, active_new, n_drop = promote_tail(Z, Z_tail, tail_g, gs.active)
        stats = local_stats(X_shards, Z)
        A, pi, active, _ = master_step1(stats, active_new, gs, N_g, D)
        Z = Z * active[None, None, :]
        sse = local_sse(X_shards, Z, A, active)
        return _finish_sync(gs, Z, Z_tail, tail_active, A, pi, active, sse,
                            n_drop, n_sat, hyp, N_g, P_)


def _chain_iteration_body(
    X_shards: Tensor,  # (P, N_p, D), shared by every chain
    gs: HybridGlobal,
    ss: HybridShard,
    hyp,
    L: int,
    N_g: float,
    chol_refresh: int = DEFAULT_REFRESH,
    collapsed_backend: str = "fast",
) -> tuple[HybridGlobal, HybridShard]:
    """One full hybrid iteration of C independent chains (every leaf of
    ``gs`` and ``ss`` with a leading chain axis): the reference's
    ``_hybrid_iteration_body`` under ``jax.vmap``. The sub-iterations run
    the C tails as one chained scan; each chain's sync is its own."""
    Z, Z_tail, tail_active, n_sat = shard_sub_iterations(
        X_shards, ss.Z, ss.Z_tail, ss.tail_active, gs, N_g, L,
        chol_refresh=chol_refresh, collapsed_backend=collapsed_backend,
    )
    outs = [_master_sync(X_shards, chain_of(gs, c), Z[c], Z_tail[c],
                         tail_active[c], n_sat[c], hyp, N_g)
            for c in range(Z.shape[0])]
    return (stack_chains([o[0] for o in outs]),
            stack_chains([o[1] for o in outs]))


def _chain_stale_body(
    X_shards: Tensor,
    gs: HybridGlobal,
    ss: HybridShard,
    L: int,
    N_g: float,
    chol_refresh: int = DEFAULT_REFRESH,
    collapsed_backend: str = "fast",
) -> tuple[HybridGlobal, HybridShard]:
    """Bounded-staleness pass of C chains (chain-batched state): the
    sub-iterations WITHOUT the master sync (DESIGN.md §10).

    Shards keep Gibbs-sweeping Z (and p′ keeps exploring its tail)
    against stale global parameters; tails carry over into the next full
    iteration's promotion. Non-exact by construction. The key consumed by
    the sweeps (fold 13) and the key handed on (fold 14) differ:
    returning the consumed key would make the next iteration replay the
    same uniforms. ``gs`` is otherwise untouched: saturation on a stale
    pass is not counted, as in the reference.
    """
    gs_sweep = dataclasses.replace(gs, key=prng.fold_in(gs.key, 13))
    Z, Z_tail, tail_active, _ = shard_sub_iterations(
        X_shards, ss.Z, ss.Z_tail, ss.tail_active, gs_sweep, N_g, L,
        chol_refresh=chol_refresh, collapsed_backend=collapsed_backend,
    )
    gs_out = dataclasses.replace(gs, key=prng.fold_in(gs.key, 14))
    return gs_out, HybridShard(Z=Z, Z_tail=Z_tail, tail_active=tail_active)


def _one_chain(fn, X_shards: Tensor, gs: HybridGlobal, ss: HybridShard,
               *args) -> tuple[HybridGlobal, HybridShard]:
    """A chain-batched body run on a chainless state, as a chain of one."""
    gs, ss = fn(X_shards, stack_chains([gs]), stack_chains([ss]), *args)
    return chain_of(gs, 0), chain_of(ss, 0)


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
    """One full hybrid iteration (sub-iterations + master sync) of one
    chain: ``_chain_iteration_body`` on a chain of one."""
    return _one_chain(_chain_iteration_body, X_shards, gs, ss, hyp, L, N_g,
                      chol_refresh, collapsed_backend)


def _hybrid_stale_body(
    X_shards: Tensor,
    gs: HybridGlobal,
    ss: HybridShard,
    L: int,
    N_g: float,
    chol_refresh: int = DEFAULT_REFRESH,
    collapsed_backend: str = "fast",
) -> tuple[HybridGlobal, HybridShard]:
    """The bounded-staleness pass of one chain: ``_chain_stale_body`` on a
    chain of one."""
    return _one_chain(_chain_stale_body, X_shards, gs, ss, L, N_g,
                      chol_refresh, collapsed_backend)


# --------------------------------------------------------------------------
# the spec-driven construction path (the reference's DESIGN.md §13)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HybridFns:
    """The iteration functions of a layout: ``step(X_shards, gs, ss) ->
    (gs, ss)`` and the bounded-staleness pass ``stale`` in the same
    convention, on HybridShard state (chain-batched leaves when
    chains="vmap")."""

    step: Any
    stale: Any


def build_hybrid_fns(spec, hyp, *, N_global: int, mesh=None) -> HybridFns:
    """Build the hybrid iteration for ``spec``'s parallelism layout: the
    kernel knobs (``L``, ``collapsed_backend``, ``chol_refresh``) and the
    layout (``chains`` x ``data``) are read off ``spec`` (a
    ``SamplerSpec`` or anything with those attributes); a distributed
    layout runs as this process's rank of ``mesh``."""
    N_g = float(N_global)
    if spec.data == "vmap":  # under chains="mesh", the rank's one chain
        return _build_vmap_fns(spec, hyp, N_g)
    return _build_mesh_fns(spec, hyp, N_g, mesh)


def _build_vmap_fns(spec, hyp, N_g: float) -> HybridFns:
    """The iteration of the chains on one device, P shards as a batch
    axis: with chains="vmap" C chains as a leading axis of every state
    leaf (the reference vmaps the iteration over it; here the C tails
    share one chained scan), else one chain (under chains="mesh" x
    data="vmap", the rank's chain c: no collective)."""
    L, cb, cr = spec.L, spec.collapsed_backend, spec.chol_refresh
    if spec.chains == "vmap":
        body, stale = _chain_iteration_body, _chain_stale_body
    else:
        body, stale = _hybrid_iteration_body, _hybrid_stale_body

    def step(Xs, gs, ss):
        return body(Xs, gs, ss, hyp, L, N_g, cr, cb)

    def stale_pass(Xs, gs, ss):
        return stale(Xs, gs, ss, L, N_g, cr, cb)

    return HybridFns(step=step, stale=stale_pass)


# --------------------------------------------------------------------------
# data="shardmap": a shard a process, the collectives of ``parallel``
# --------------------------------------------------------------------------


def _rank_sub_iterations(
    X_p: Tensor,
    gs: HybridGlobal,
    ss: HybridShard,
    p: int,
    L: int,
    N_g: float,
    chol_refresh: int,
    collapsed_backend: str,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """``shard_sub_iterations`` on this rank's shard (global index ``p``,
    the rank's data coordinate): X_p (1, N_p, D), ``ss`` leaves (1, ...),
    ``gs`` chainless. Returns (Z, Z_tail, tail_active, n_sat ())."""
    Z, Z_tail, tail_active, n_sat = shard_sub_iterations(
        X_p, ss.Z[None], ss.Z_tail[None], ss.tail_active[None],
        stack_chains([gs]), N_g, L, chol_refresh, collapsed_backend,
        shards=(p,))
    return Z[0], Z_tail[0], tail_active[0], n_sat[0]


def sse_identity(xx: Tensor, ZtZ: Tensor, ZtX: Tensor, A: Tensor,
                 active: Tensor) -> Tensor:
    """‖X − (Z∘active)A‖² from the statistics: tr(XᵀX) − 2⟨A, ZᵀX⟩ +
    ⟨A, (ZᵀZ) A⟩ over the active columns, in float32 as the reference."""
    ZtXm = ZtX * active[:, None]
    ZtZm = ZtZ * ibm.mask_outer(active)
    return xx - 2.0 * torch.sum(A * ZtXm) + torch.sum(A * (ZtZm @ A))


def _staged_sync(X_p, gs, Z, Z_tail, tail_active, n_sat, hyp, N_g, P_,
                 group=None):
    """The reference's ``block_staged``: three all-reduces over the data
    axis's ``group``, (1) the tail mask and the saturation count, (2) (m,
    ZᵀZ, ZᵀX) of this rank's rows after the promotion, (3) this rank's
    SSE."""
    D = X_p.shape[-1]
    with tracing.span("sync"):
        tail_g, sat = parallel.all_reduce_sum(                      # AR 1
            tail_active[0], n_sat.to(tail_active.dtype)[None], group=group)
        Z, active_new, n_drop = promote_tail(Z, Z_tail, tail_g, gs.active)
        s = local_stats(X_p, Z)
        ZtZ, ZtX, m = parallel.all_reduce_sum(                      # AR 2
            s["ZtZ"], s["ZtX"], s["m"], group=group)
        A, pi, active, _ = master_step1({"m": m, "ZtZ": ZtZ, "ZtX": ZtX},
                                        active_new, gs, N_g, D)
        Z = Z * active[None, None, :]
        sse = parallel.all_reduce_sum(local_sse(X_p, Z, A, active),  # AR 3
                                      group=group)
        return _finish_sync(gs, Z, Z_tail, tail_active, A, pi, active, sse,
                            n_drop, sat[0].to(torch.int32), hyp, N_g, P_)


def fused_payload(X_p, active, Z, Z_tail, tail_active, n_sat
                  ) -> tuple[Tensor, ...]:
    """This rank's part of the fused sync's one all-reduce, in the
    reference's order: ZᵀZ, ZᵀX, m (taken with the rank's own tail
    pre-scattered: zero columns but on p′, which uses the slot assignment
    every rank derives after the reduce), the tail mask, ΣX², and n_sat
    as a float."""
    Z_stats, _, _ = promote_tail(Z, Z_tail, tail_active[0], active)
    s = local_stats(X_p, Z_stats)
    return (s["ZtZ"], s["ZtX"], s["m"], tail_active[0],
            torch.sum(X_p * X_p)[None], n_sat.to(X_p.dtype)[None])


def _fused_sync(X_p, gs, Z, Z_tail, tail_active, n_sat, hyp, N_g, P_,
                group=None):
    """The reference's ``block_fused``: ONE all-reduce of
    ``fused_payload`` over the data axis's ``group``; the SSE comes from
    the reduced statistics (``sse_identity``), so no ``gaussian_sse``
    runs."""
    with tracing.span("sync"):
        ZtZ, ZtX, m, tail_g, xx, sat = parallel.all_reduce_sum(    # AR
            *fused_payload(X_p, gs.active, Z, Z_tail, tail_active, n_sat),
            group=group)
        Z, active_new, n_drop = promote_tail(Z, Z_tail, tail_g, gs.active)
        A, pi, active, _ = master_step1({"m": m, "ZtZ": ZtZ, "ZtX": ZtX},
                                        active_new, gs, N_g, X_p.shape[-1])
        Z = Z * active[None, None, :]
        sse = sse_identity(xx[0], ZtZ, ZtX, A, active)
        return _finish_sync(gs, Z, Z_tail, tail_active, A, pi, active, sse,
                            n_drop, sat[0].to(torch.int32), hyp, N_g, P_)


def _build_mesh_fns(spec, hyp, N_g: float, mesh) -> HybridFns:
    """data="shardmap": this process is a rank of ``mesh``
    (``parallel.Mesh``), shard p of its data group (p its "data"
    coordinate; under chains="mesh" the P ranks of its chain c), and
    holds shard p of one chain (X_p (1, N_p, D), HybridShard leaves (1,
    ...)). The chain's HybridGlobal is replicated over the data group:
    every rank draws the master's parameters itself from the same keys
    and reduced statistics. ``step`` runs the sub-iterations on the
    rank's rows (the tail on p′'s rank only), then the ``spec.sync``
    schedule over the data group, "staged" (3 all-reduces) or "fused"
    (1). ``stale`` makes no collective: the fold-13 sweep key, the
    fold-14 key handed on, as ``_chain_stale_body``. No collective
    crosses the chain axis: each chain is the data-parallel algorithm
    on its own state."""
    L, cb, cr, P_ = spec.L, spec.collapsed_backend, spec.chol_refresh, spec.P
    p, group = mesh.axis_index("data"), mesh.group("data")
    sync = _fused_sync if spec.sync == "fused" else _staged_sync

    def step(X_p, gs, ss):
        out = _rank_sub_iterations(X_p, gs, ss, p, L, N_g, cr, cb)
        return sync(X_p, gs, *out, hyp, N_g, P_, group)

    def stale_pass(X_p, gs, ss):
        gs_sweep = dataclasses.replace(gs, key=prng.fold_in(gs.key, 13))
        Z, Z_tail, tail_active, _ = _rank_sub_iterations(
            X_p, gs_sweep, ss, p, L, N_g, cr, cb)
        gs_out = dataclasses.replace(gs, key=prng.fold_in(gs.key, 14))
        return gs_out, HybridShard(Z=Z, Z_tail=Z_tail,
                                   tail_active=tail_active)

    return HybridFns(step=step, stale=stale_pass)
