"""Convergence diagnostics for (multi-chain) MCMC output (DESIGN.md §11).

These are host-side diagnostics over collected sample traces — plain
numpy on ``(C, T)`` arrays (C chains, T post-burn-in draws). They back
three consumers:

* ``runtime/driver.py`` eval records (split-R-hat / ESS / MCSE of the
  monitored scalars, computed from the driver's per-iteration trace);
* the statistical test suite (``tests/test_exactness.py``), which
  replaces hard single-chain tolerances with MCSE/ESS-aware z-tests;
* the Geweke-style "getting it right" joint-distribution check, where
  two successive-conditional simulators are compared via ``mean_diff_z``.

Conventions follow Vehtari et al. (2021) rank-free forms: split-R-hat
splits every chain in half (so a single stuck-then-jumped chain is
caught even at C=1), and ESS uses Geyer's initial-positive-sequence
truncation over chain-averaged autocovariances.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "split_rhat",
    "ess",
    "mcse",
    "geweke_z",
    "mean_diff_z",
    "summarize",
]


def _as_chains(x) -> np.ndarray:
    """Coerce to (C, T) float64; a 1-D trace becomes one chain."""
    a = np.asarray(x, np.float64)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError(f"expected (C, T) or (T,) trace, got shape {a.shape}")
    return a


def _split_halves(a: np.ndarray) -> np.ndarray:
    """(C, T) -> (2C, T//2): each chain split into first/second half."""
    C, T = a.shape
    h = T // 2
    return np.concatenate([a[:, :h], a[:, T - h:]], axis=0)


def split_rhat(x) -> float:
    """Potential scale reduction over half-split chains.

    ~1 at convergence; conventional alarm threshold 1.01-1.05. Returns
    NaN when there are fewer than 4 draws per half-chain or zero
    variance everywhere (a constant trace is 'converged' but R-hat is
    undefined; callers treat NaN as no-evidence-of-trouble).
    """
    a = _split_halves(_as_chains(x))
    M, T = a.shape
    if T < 4:
        return float("nan")
    means = a.mean(axis=1)
    W = a.var(axis=1, ddof=1).mean()
    B = T * means.var(ddof=1)
    if W <= 0.0:
        return float("nan") if B <= 0.0 else float("inf")
    var_plus = (T - 1) / T * W + B / T
    return float(np.sqrt(var_plus / W))


def ess(x) -> float:
    """Effective sample size across chains (Geyer initial positive seq.).

    Autocovariances are averaged across chains at each lag; the sum of
    paired autocorrelations is truncated at the first non-positive pair.
    Bounded to [1, C*T].
    """
    a = _as_chains(x)
    C, T = a.shape
    n = C * T
    if T < 4:
        return float(n)
    W = a.var(axis=1, ddof=1).mean()
    means = a.mean(axis=1)
    var_plus = (T - 1) / T * W + (T * means.var(ddof=1) / T if C > 1 else 0.0)
    if var_plus <= 0.0:
        return float(n)

    # chain-averaged autocovariance via FFT
    am = a - means[:, None]
    m = 1 << (2 * T - 1).bit_length()
    f = np.fft.rfft(am, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :T].real / T
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus   # (T,) combined rho_t

    # Geyer: sum rho over pairs (rho_{2k} + rho_{2k+1}) while positive
    tau = 1.0
    t = 1
    while t + 1 < T:
        pair = rho[t] + rho[t + 1]
        if pair <= 0.0:
            break
        tau += 2.0 * pair
        t += 2
    return float(np.clip(n / tau, 1.0, n))


def mcse(x) -> float:
    """Monte-Carlo standard error of the mean: sd / sqrt(ESS)."""
    a = _as_chains(x)
    sd = a.std(ddof=1)
    if sd == 0.0:
        return 0.0
    return float(sd / np.sqrt(ess(a)))


def geweke_z(x, first: float = 0.1, last: float = 0.5) -> float:
    """Geweke (1992) stationarity z-score of one pooled trace.

    Compares the mean of the first ``first`` fraction against the last
    ``last`` fraction, standardized by ESS-aware MCSEs of each window.
    |z| > ~3 signals the window means disagree (non-stationary trace).
    """
    a = _as_chains(x)
    T = a.shape[1]
    w0 = a[:, : max(2, int(first * T))]
    w1 = a[:, T - max(2, int(last * T)):]
    se = np.hypot(mcse(w0), mcse(w1))
    if se == 0.0:
        return 0.0
    return float((w0.mean() - w1.mean()) / se)


def mean_diff_z(x, y) -> float:
    """z-score of E[x] - E[y] under independent-chain MCSEs.

    The MCSE/ESS-aware replacement for hard relative tolerances when
    checking that two samplers target the same posterior: |z| < ~4
    means the observed gap is within Monte-Carlo error.
    """
    se = np.hypot(mcse(x), mcse(y))
    if se == 0.0:
        return 0.0 if np.isclose(_as_chains(x).mean(), _as_chains(y).mean()) \
            else float("inf")
    return float((_as_chains(x).mean() - _as_chains(y).mean()) / se)


def summarize(x, prefix: str = "") -> dict[str, float]:
    """{rhat, ess, mcse, mean, sd} of one (C, T) trace, for eval records."""
    a = _as_chains(x)
    p = f"{prefix}_" if prefix else ""
    return {
        f"{p}mean": float(a.mean()),
        f"{p}sd": float(a.std(ddof=1)) if a.size > 1 else 0.0,
        f"{p}rhat": split_rhat(a),
        f"{p}ess": ess(a),
        f"{p}mcse": mcse(a),
    }
