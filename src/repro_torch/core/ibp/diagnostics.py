"""Evaluation: joint log-likelihood on held-out data (paper Fig. 1) and
posterior feature recovery (paper Fig. 2).

Port of ``repro/core/ibp/diagnostics.py``. ``heldout_joint_loglik`` and
``train_joint_loglik`` are re-exports of the port's ``predict``;
``match_features`` is host numpy, a copy of the reference's.
"""
from __future__ import annotations

import numpy as np

from .predict import heldout_joint_loglik, train_joint_loglik  # noqa: F401

__all__ = ["heldout_joint_loglik", "train_joint_loglik", "match_features"]


def match_features(A_est: np.ndarray,
                   A_true: np.ndarray) -> tuple[np.ndarray, float]:
    """Greedy L2 matching of recovered features to ground truth.

    Returns (A_est reordered to match A_true rows, mean per-feature SSE).
    """
    A_est = np.asarray(A_est, dtype=np.float64)
    A_true = np.asarray(A_true, dtype=np.float64)
    Kt = A_true.shape[0]
    used: set[int] = set()
    picked = []
    sses = []
    for t in range(Kt):
        best, best_sse = -1, np.inf
        for e in range(A_est.shape[0]):
            if e in used:
                continue
            sse = float(np.sum((A_est[e] - A_true[t]) ** 2))
            if sse < best_sse:
                best, best_sse = e, sse
        used.add(best)
        picked.append(A_est[best] if best >= 0 else np.zeros_like(A_true[t]))
        sses.append(best_sse)
    return np.stack(picked), float(np.mean(sses))
