"""Collapsed Gibbs sampler for the linear-Gaussian IBP (Griffiths &
Ghahramani), and the collapsed row scan it shares with the hybrid tail.

Port of ``repro/core/ibp/collapsed.py``. A is integrated out; for each
row n the posterior-predictive form

    x_n | z_n, Z_-n, X_-n ~ N( z_n H_-,  sigma_x^2 (1 + z_n M_- z_n^T) I )

with M_- = (Z_-^T Z_- + (sx^2/sa^2) I)^{-1}, H_- = M_- Z_-^T X_-, makes
each bit flip O(K + D) once the row's posterior map is in hand. New
dishes are the exact truncated Gibbs draw over j = 0..J_MAX (the serial
sweep) or the paper's MH move (the hybrid tail). Everything is padded to
K_max with an ``active`` mask.

Row-step backends, selected by ``backend=``:

* ``"fast"`` and ``"pallas"``: the factor is CARRIED across the scan and
  moved between rows by rank-one Cholesky moves and Sherman–Morrison
  (documented beside the plain version, ``kernels/collapsed_scan/ref.py``).
  On a CUDA tensor a scan is one launch of the ``collapsed_scan`` kernel,
  with every branch of the row step decided on the device, so a scan
  costs no host sync; on a CPU tensor it is the plain version. The two
  differ in the bit flip, as in the reference: ``"fast"`` runs the rss
  form, O(K) a bit, reading G = HHᵀ, which the scan carries across rows;
  ``"pallas"`` runs the mean form, O(K + D) a bit, with no G.
* ``"ref"``: ``_row_step``, the O(K^3) oracle, a fresh factorization per
  row in plain PyTorch on any device (the reference runs it in plain jnp
  too). It runs only when asked for.

Packing (``k_live_buckets="on"``, the default, as in the reference): the
serial sweep runs the carried scan on a block of B columns, the smallest
bucket (8, 16, ..., K_max) holding K⁺ + PACK_HEADROOM, so a row costs
O(B² + BD) instead of O(K_max² + K_max·D). A birth the block cannot
place stops the scan before its row; the host repacks at the bucket the
new K⁺ needs and resumes from that row (``_packed_segments``). ``"off"``
runs the full width, B = K_max, in one segment. The hybrid tail always
runs its full K_tail width.

One departure from the reference, by rounding only: the reference's
``"fast"`` carries G only when packing (``pack=True`` in the tail,
``k_live_buckets="on"`` in the sweep) and otherwise recomputes G = HHᵀ
every row. That recompute is O(K²D) a row; the port carries G wherever
``"fast"`` runs, so ``"off"`` selects the block width only, and the
hybrid tail, which the reference switches by ``pack``, takes no such
switch: its float path is the same at either value of the spec's
``k_live_buckets``.

Chains: the hybrid tail of C independent chains is one chained scan
(a leading chain axis on the scan's state, rows and draws; one
``collapsed_scan`` launch of C blocks on the card), each chain's draws
from its own generator.

Draws: a scan's randomness is drawn up front (``draw_scan``), as the
reference hoists it, and passed in, so a test can feed the port the
reference's own draws. A resumed segment reads the draws of its rows,
as the reference's positional key chain does. The reference's chunked
uniforms (``U_CHUNK_ROWS``) have no counterpart: the sweep's uniforms are
held whole, (N, K_max) float32, 8 MB at N=32768, K_max=64. Keys are
host-side (``prng``) and the streams are not JAX's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.kernels.collapsed_row import collapsed_row_flip_ref
from repro_torch.kernels.collapsed_scan import collapsed_scan
from repro_torch.kernels.collapsed_scan.ref import (  # noqa: F401
    BIRTHS,
    J_MAX,
    PROBE_EVERY,
    _log_poisson,  # the reference's name
    _sample_dishes,
)

from . import math as ibm
from .state import IBPHypers, IBPState
from .sweeps import sufficient_stats

Tensor = torch.Tensor

COLLAPSED_BACKENDS = ("ref", "fast", "pallas")
K_LIVE_MODES = ("on", "off")  # occupancy-adaptive packing knob values
DEFAULT_REFRESH = 64      # exact refactorization cadence
DEFAULT_DRIFT_TOL = 1e-2  # probe-residual threshold forcing an early refresh
PACK_HEADROOM = J_MAX     # free in-block slots guaranteed at (re)pack time


def _check_backend(name: str) -> str:
    if name not in COLLAPSED_BACKENDS:
        raise ValueError(f"backend={name!r} not in {COLLAPSED_BACKENDS}")
    return name


@dataclasses.dataclass
class ScanDraws:
    """The row scan's random numbers, one row of each per scanned row:
    the bit-flip thresholds and, for MH births, ``j_prop`` and
    ``log_u_acc`` or, for Gibbs births, ``gumbel``."""

    u_logit: Tensor                  # (n_rows, K) logit-uniform thresholds
    j_prop: Tensor | None = None     # (n_rows,) MH proposals, Poisson(alpha/N)
    log_u_acc: Tensor | None = None  # (n_rows,) log of the MH accept uniforms
    gumbel: Tensor | None = None     # (n_rows, J_MAX + 1) standard Gumbel


def draw_scan(n_rows: int, K: int, alpha: Tensor, N: float,
              gen: torch.Generator | list[torch.Generator],
              birth: str = "mh") -> ScanDraws:
    """Draw a scan's randomness on ``alpha``'s device from ``gen``.

    Gibbs births take standard Gumbel noise, -log(-log U) with U clamped
    below at the float32 tiny, as ``jax.random.gumbel`` draws it. With
    C chains (``alpha`` of shape (C,), ``gen`` C generators) chain c's
    draws come from generator c, stacked on a leading chain axis."""
    if birth not in BIRTHS:
        raise ValueError(f"birth={birth!r} not in {BIRTHS}")
    if alpha.dim() == 1:
        per = [draw_scan(n_rows, K, a, N, g, birth)
               for a, g in zip(alpha, gen, strict=True)]
        return ScanDraws(**{
            f.name: None if getattr(per[0], f.name) is None else
            torch.stack([getattr(d, f.name) for d in per])
            for f in dataclasses.fields(ScanDraws)})
    dev, dt = alpha.device, alpha.dtype
    uu = torch.rand((n_rows, K), generator=gen, dtype=dt, device=dev)
    uu = torch.clamp(uu, 1e-7, 1.0 - 1e-7)
    draws = ScanDraws(u_logit=torch.log(uu) - torch.log1p(-uu))
    if birth == "gibbs":
        ug = torch.rand((n_rows, J_MAX + 1), generator=gen, dtype=dt,
                        device=dev)
        ug = torch.clamp(ug, min=torch.finfo(dt).tiny)
        draws.gumbel = -torch.log(-torch.log(ug))
    else:
        lam = (alpha / N) * torch.ones((n_rows,), dtype=dt, device=dev)
        draws.j_prop = torch.poisson(lam, generator=gen)
        draws.log_u_acc = torch.log(torch.rand((n_rows,), generator=gen,
                                               dtype=dt, device=dev))
    return draws


def _row_step(carry: tuple, n: int, *, X: Tensor, draws: ScanDraws,
              N: Tensor, birth: str) -> tuple:
    """Resample row n's bits and new dishes, collapsed: the O(K^3) oracle.

    A fresh padded-W factorization per row, the plain flip, then the
    dish move; no carried factor. ``N`` is the GLOBAL observation count,
    a 0-d tensor (the hybrid tail runs on one shard's rows with global-N
    priors). No value is read back to the host, so on a CUDA tensor a row
    queues its work without waiting on the device. The trailing carry
    element accumulates the MH births' saturation flag.
    """
    Z, active, ZtZ, ZtX, m, alpha, sx, sa, n_sat = carry
    D = X.shape[1]
    x_n = X[n]
    z = Z[n]
    # ---- remove row n from the sufficient statistics
    m_minus = m - z
    ZtZ_m = ZtZ - torch.outer(z, z)
    ZtX_m = ZtX - torch.outer(z, x_n)
    # drop row-n singletons (m_minus == 0 while z == 1): they are
    # re-proposed as part of the new-dish step (exact G&G scheme)
    singleton = active * (m_minus <= 0.5) * z
    z = z * (1.0 - singleton)
    active_m = active * (1.0 - (active * (m_minus <= 0.5)))
    # ---- per-row factorization (exact; no carried state)
    ratio = (sx / sa) ** 2
    M, _ = ibm.chol_inv_logdet(ibm.padded_W(ZtZ_m, active_m, ratio))
    M = M * ibm.mask_outer(active_m)
    H = M @ (ZtX_m * active_m[:, None])  # (K, D) posterior mean map
    v = M @ z
    q = torch.dot(z, v)
    mean = z @ H
    inv2s2 = 0.5 / (sx**2)
    z, v, q, mean = collapsed_row_flip_ref(
        M, H, x_n, z, v, q, mean, draws.u_logit[n], m_minus, active_m, N,
        inv2s2)
    # ---- new dishes, j = 0..J_MAX
    if birth == "gibbs":
        draw, lam = draws.gumbel[n], alpha / N
    else:
        draw, lam = (draws.j_prop[n], draws.log_u_acc[n]), None
    z, active_new, _, _, sat = _sample_dishes(
        birth, draw, q, mean, x_n, active_m, z, sx, sa, lam, D)
    # ---- add row n back
    m_new = m_minus * active_m + z  # dead/singleton cols contribute 0
    ZtZ_n = ZtZ_m * ibm.mask_outer(active_m) + torch.outer(z, z)
    ZtX_n = ZtX_m * active_m[:, None] + torch.outer(z, x_n)
    Z[n] = z
    return (Z, active_new, ZtZ_n, ZtX_n, m_new, alpha, sx, sa,
            n_sat + sat.to(n_sat.dtype))


def _segment_scan(Z: Tensor, active: Tensor, ZtZ: Tensor, ZtX: Tensor,
                  m: Tensor, X: Tensor, sx: Tensor, sa: Tensor,
                  draws: ScanDraws, *, N: float, alpha: Tensor | None,
                  birth: str, backend: str, refresh_every: int,
                  drift_tol: float, B: int, start_row: int = 0) -> Tensor:
    """One segment of the carried scan, the counterpart of the
    reference's ``_packed_scan``: rows ``start_row``.. on the packed
    block of ``B`` columns, flip flavor ``backend`` ("fast" or "pallas").
    Moves the canonical Z, active, ZtZ, ZtX and m in place and returns
    the int32 device counts (n_refresh, n_sat, ovf_row), (C, 3) for a
    chained scan; ``ovf_row`` is the first row not committed, or -1 when
    the segment reached the last row."""
    gibbs = birth == "gibbs"
    return collapsed_scan(
        Z, active, ZtZ, ZtX, m, X, draws.u_logit, draws.j_prop,
        draws.log_u_acc, sx, sa, N=N, refresh_every=refresh_every,
        drift_tol=drift_tol, gumbel=draws.gumbel if gibbs else None,
        alpha=alpha if gibbs else None, flavor=backend, B=B,
        start_row=start_row)


def collapsed_row_scan(
    Z: Tensor,
    active: Tensor,
    ZtZ: Tensor,
    ZtX: Tensor,
    m: Tensor,
    X: Tensor,
    sx: Tensor,
    sa: Tensor,
    draws: ScanDraws,
    *,
    N: float,
    alpha: Tensor | None = None,
    birth: str = "mh",
    backend: str = "pallas",
    refresh_every: int = DEFAULT_REFRESH,
    drift_tol: float = DEFAULT_DRIFT_TOL,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Scan the collapsed row step over every row of ``X`` at the full
    width: the carried scan (``backend`` "fast" or "pallas") or the
    oracle (``"ref"``).

    The shared entry of the serial sweep at ``k_live_buckets="off"``
    (``birth="gibbs"``, which needs ``alpha`` and ``draws.gumbel``) and
    the hybrid tail (``birth="mh"``). ``N`` is the GLOBAL observation
    count. The reference's ``pack`` switch has no counterpart: the port
    carries G for ``"fast"`` at every width (module docstring). Returns
    (Z, active, ZtZ, ZtX, m, n_refresh, n_sat), the last two int32 device scalars: exact
    refactorizations (0 on the ``"ref"`` backend, which has no carry)
    and capacity-vetoed accepted MH births (0 for Gibbs births). The
    caller's tensors are not modified.

    C chains (the hybrid tail of a chain-batched state): every argument
    but ``N`` with a leading chain axis, ``draws`` as ``draw_scan`` stacks
    them, MH births; the carried scan is one chained launch, the oracle
    runs chain by chain; every output gains the chain axis.
    """
    backend = _check_backend(backend)
    if birth not in BIRTHS:
        raise ValueError(f"birth={birth!r} not in {BIRTHS}")
    if birth == "gibbs" and (alpha is None or draws.gumbel is None):
        raise ValueError("Gibbs births need alpha and draws.gumbel")
    if Z.dim() == 3 and backend == "ref":
        outs = [collapsed_row_scan(
            Z[c], active[c], ZtZ[c], ZtX[c], m[c], X[c], sx[c], sa[c],
            ScanDraws(**{f.name: None if getattr(draws, f.name) is None
                         else getattr(draws, f.name)[c]
                         for f in dataclasses.fields(ScanDraws)}),
            N=N, alpha=None if alpha is None else alpha[c], birth=birth,
            backend=backend) for c in range(Z.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    Z, active, ZtZ, ZtX, m = (t.clone(memory_format=torch.contiguous_format)
                              for t in (Z, active, ZtZ, ZtX, m))
    if backend == "ref":
        n_sat = torch.zeros((), dtype=torch.int32, device=X.device)
        N_t = torch.tensor(N, dtype=X.dtype, device=X.device)
        carry = (Z, active, ZtZ, ZtX, m, alpha, sx, sa, n_sat)
        for n in range(X.shape[0]):
            carry = _row_step(carry, n, X=X, draws=draws, N=N_t, birth=birth)
        return (*carry[:5], torch.zeros_like(n_sat), carry[8])
    counts = _segment_scan(
        Z, active, ZtZ, ZtX, m, X, sx, sa, draws, N=N, alpha=alpha,
        birth=birth, backend=backend, refresh_every=refresh_every,
        drift_tol=drift_tol, B=Z.shape[-1])
    return Z, active, ZtZ, ZtX, m, counts[..., 0], counts[..., 1]


def _sweep_stats(Z: Tensor, active: Tensor, X: Tensor
                 ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Exact sweep-entry statistics (m, ZtZ, ZtX) masked to the live
    columns, through ``feature_stats``, and tr XᵀX for the sigma moves."""
    m, ZtZ, ZtX, trXtX = sufficient_stats(X, Z)
    return (m * active, ZtZ * ibm.mask_outer(active), ZtX * active[:, None],
            trXtX)


def _finish_sweep(state: IBPState, X: Tensor, hyp: IBPHypers, Z: Tensor,
                  active: Tensor, ZtZ: Tensor, ZtX: Tensor, m: Tensor,
                  trXtX: Tensor, key: Tensor, kalpha: Tensor, ksx: Tensor,
                  ksa: Tensor) -> IBPState:
    """Post-scan pruning and hyper-parameter updates. No value is read
    back to the host: the MH accepts are ``torch.where``s."""
    N, D = X.shape
    dev = X.device
    alpha, sx, sa = state.alpha, state.sigma_x, state.sigma_a

    # prune columns that died during the sweep
    active = active * (m > 0.5)
    mask2 = ibm.mask_outer(active)
    ZtZ = ZtZ * mask2
    ZtX = ZtX * active[:, None]
    Z = Z * active[None, :]
    k_plus = torch.sum(active)

    # alpha | K+ ~ Gamma(a + K+, b + H_N)
    if hyp.resample_alpha:
        alpha = ibm.gamma_draw(prng.generator(kalpha, dev),
                               hyp.a_alpha + k_plus,
                               hyp.b_alpha + ibm.harmonic(N))

    # sigma_x, sigma_a via random-walk MH on log-scale against the
    # collapsed likelihood
    if hyp.resample_sigmas:
        def cll(sx_, sa_):
            return ibm.collapsed_loglik(trXtX, ZtX, ZtZ, active, float(N), D,
                                        sx_, sa_)

        def mh(key_, cur, other, which):
            g = prng.generator(key_, dev)
            prop = cur * torch.exp(0.1 * torch.randn(
                (), generator=g, dtype=cur.dtype, device=dev))
            if which == "x":
                d = cll(prop, other) - cll(cur, other)
            else:
                d = cll(other, prop) - cll(other, cur)
            # log-normal RW: include the log-scale Jacobian
            d = d + torch.log(prop) - torch.log(cur)
            acc = torch.log(torch.rand((), generator=g, dtype=cur.dtype,
                                       device=dev)) < d
            return torch.where(acc, prop, cur)

        sx = mh(ksx, sx, sa, "x")
        sa = mh(ksa, sa, sx, "a")

    return IBPState(
        Z=Z, A=state.A, pi=state.pi, active=active, tail=state.tail,
        alpha=alpha, sigma_x=sx, sigma_a=sa, key=key,
        p_prime=state.p_prime, it=state.it + 1,
    )


def _packed_segments(Z: Tensor, active: Tensor, ZtZ: Tensor, ZtX: Tensor,
                     m: Tensor, X: Tensor, sx: Tensor, sa: Tensor,
                     alpha: Tensor, draws: ScanDraws, k_plus: int, *,
                     backend: str, refresh_every: int,
                     seg_log: list | None = None) -> None:
    """The packed sweep's scan, segment by segment (the host loop of the
    reference's ``_collapsed_sweep_packed``): each segment runs at the
    smallest bucket holding ``k_plus`` live columns plus PACK_HEADROOM
    free ones (``ibm.pick_bucket``); a birth that overflows its block
    ends the segment before its row, and the next one resumes from that
    row at the bucket of the new K⁺. A resume always makes progress: the
    larger block has room for the pending birth. Moves the canonical
    Z, active, ZtZ, ZtX and m in place, with Gibbs births. One host read
    per segment, of ``ovf_row`` and K⁺ together. ``seg_log`` receives one
    ``(bucket, start_row)`` per segment."""
    N = X.shape[0]
    buckets = ibm.live_buckets(Z.shape[1])
    row = 0
    while True:
        B = ibm.pick_bucket(buckets, k_plus, PACK_HEADROOM)
        # a live column left out of the block would lose its statistics
        assert B >= k_plus, (B, k_plus)
        if seg_log is not None:
            seg_log.append((B, row))
        counts = _segment_scan(
            Z, active, ZtZ, ZtX, m, X, sx, sa, draws, N=float(N),
            alpha=alpha, birth="gibbs", backend=backend,
            refresh_every=refresh_every, drift_tol=DEFAULT_DRIFT_TOL, B=B,
            start_row=row)
        row, k_plus = torch.stack(
            [counts[2], torch.sum(active).to(torch.int32)]).tolist()
        if row < 0:
            return


def collapsed_sweep(
    state: IBPState,
    X: Tensor,
    hyp: IBPHypers,
    backend: str = "pallas",
    refresh_every: int = DEFAULT_REFRESH,
    k_live_buckets: str = "on",
    seg_log: list | None = None,
) -> IBPState:
    """One full collapsed Gibbs sweep over all rows, with Gibbs births,
    then pruning and the hyper-parameter updates.

    ``k_live_buckets="on"`` (the reference's default) runs the carried
    scan on the live-K⁺ bucket, segment by segment
    (``_packed_segments``): on a CUDA state one ``feature_stats`` launch
    and one ``collapsed_scan`` launch per segment, with one host read of
    K⁺ before the first and one of (``ovf_row``, K⁺) after each.
    ``"off"`` runs the full width in one launch with no host read. The
    ``"ref"`` backend has no carry and ignores the knob, as in the
    reference. The default backend is ``"pallas"`` where the reference's
    is ``"ref"``, so that a default sweep runs the carried scan, which
    on a CUDA state is the kernel. ``seg_log`` receives the packed
    sweep's ``(bucket, start_row)`` per segment.
    """
    if k_live_buckets not in K_LIVE_MODES:
        raise ValueError(
            f"k_live_buckets={k_live_buckets!r} not in {K_LIVE_MODES}")
    backend = _check_backend(backend)
    N, D = X.shape
    Z, active = state.Z, state.active
    packed = backend != "ref" and k_live_buckets == "on"
    k_plus = int(torch.sum(active)) if packed else 0
    m, ZtZ, ZtX, trXtX = _sweep_stats(Z, active, X)
    key, ksweep, kalpha, ksx, ksa = prng.split(state.key, 5)
    draws = draw_scan(N, Z.shape[1], state.alpha, float(N),
                      prng.generator(ksweep, X.device), birth="gibbs")
    if packed:
        Z = Z.clone(memory_format=torch.contiguous_format)
        active = active.clone()
        _packed_segments(Z, active, ZtZ, ZtX, m, X, state.sigma_x,
                         state.sigma_a, state.alpha, draws, k_plus,
                         backend=backend, refresh_every=refresh_every,
                         seg_log=seg_log)
    else:
        Z, active, ZtZ, ZtX, m, _, _ = collapsed_row_scan(
            Z, active, ZtZ, ZtX, m, X, state.sigma_x, state.sigma_a, draws,
            N=float(N), alpha=state.alpha, birth="gibbs", backend=backend,
            refresh_every=refresh_every)
    return _finish_sweep(state, X, hyp, Z, active, ZtZ, ZtX, m, trXtX, key,
                         kalpha, ksx, ksa)
