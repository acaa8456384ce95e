"""The canonical 'Cambridge' synthetic data set (Griffiths & Ghahramani 2011).

Four fixed binary 6x6 base images; each observation activates each feature
independently with probability 1/2 and adds isotropic Gaussian noise:

    X = Z A_true + eps,  eps ~ N(0, sigma_n^2),  X in R^{N x 36}.

The paper evaluates on the 1000 x 36 instance of this set.
"""
from __future__ import annotations

import numpy as np

# 4 features, each a 6x6 binary image (flattened to 36)
_F1 = np.array([
    [1, 1, 1, 0, 0, 0],
    [1, 0, 1, 0, 0, 0],
    [1, 1, 1, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
])
_F2 = np.array([
    [0, 0, 0, 1, 1, 1],
    [0, 0, 0, 1, 1, 0],
    [0, 0, 0, 1, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
])
_F3 = np.array([
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 0],
    [1, 1, 0, 0, 0, 0],
    [1, 1, 1, 0, 0, 0],
])
_F4 = np.array([
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 1],
    [0, 0, 0, 1, 1, 1],
    [0, 0, 0, 0, 1, 1],
])

CAMBRIDGE_FEATURES = np.stack(
    [f.reshape(-1) for f in (_F1, _F2, _F3, _F4)]
).astype(np.float32)  # (4, 36)


def cambridge_data(
    N: int = 1000,
    sigma_n: float = 0.5,
    seed: int = 0,
    p_feature: float = 0.5,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (X (N,36), Z_true (N,4), A_true (4,36))."""
    rng = np.random.default_rng(seed)
    Z = (rng.random((N, 4)) < p_feature).astype(np.float32)
    # guarantee no all-zero rows dominate tiny sets (match G&G: rows may be 0)
    X = Z @ CAMBRIDGE_FEATURES + sigma_n * rng.standard_normal((N, 36)).astype(
        np.float32
    )
    return X.astype(np.float32), Z, CAMBRIDGE_FEATURES.copy()
