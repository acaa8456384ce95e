"""Host-side observation sharding — the paper's 'divide X and Z along the
observation axis across P processors'."""
from __future__ import annotations

import numpy as np


def train_eval_split(X: np.ndarray, eval_frac: float = 0.1, seed: int = 0):
    """Deterministic held-out split (paper evaluates joint lik on held-out)."""
    rng = np.random.default_rng(seed)
    N = X.shape[0]
    perm = rng.permutation(N)
    n_eval = int(round(N * eval_frac))
    return X[perm[n_eval:]], X[perm[:n_eval]]


def shard_rows(X: np.ndarray, P: int) -> np.ndarray:
    """(N, D) -> (P, N_p, D), padding the tail by repeating the last row.

    Padding rows are real observations duplicated; for MCMC this perturbs the
    target slightly, so we instead TRIM to a multiple of P (exactness first).
    """
    N = X.shape[0]
    N_trim = (N // P) * P
    return X[:N_trim].reshape(P, N_trim // P, *X.shape[1:])


def unshard_rows(Xs: np.ndarray) -> np.ndarray:
    return Xs.reshape(-1, *Xs.shape[2:])
