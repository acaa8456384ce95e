"""Per-sample joint log-likelihoods for the driver's eval records.

Port of ``heldout_joint_loglik`` and ``train_joint_loglik`` from
``repro/core/ibp/predict.py``. The sample bank and the serving scorers
come with a later slice (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels.gaussian_sse import gaussian_sse

from . import math as ibm
from .sweeps import uncollapsed_sweep

Tensor = torch.Tensor

DEFAULT_LL_SWEEPS = 3


def heldout_joint_loglik(X_test: Tensor, A: Tensor, pi: Tensor,
                         active: Tensor, sigma_x: Tensor, key: Tensor,
                         n_sweeps: int = DEFAULT_LL_SWEEPS) -> Tensor:
    """log P(X_test, Z_test | A, pi, sigma) with Z_test imputed by short
    uncollapsed Gibbs given ONE posterior draw (paper Fig. 1 metric).
    The residual is scored by the ``gaussian_sse`` kernel."""
    N = X_test.shape[0]
    Z = torch.zeros((N, A.shape[0]), dtype=X_test.dtype, device=X_test.device)
    for l in range(n_sweeps):
        Z = uncollapsed_sweep(X_test, Z, A, pi, active, sigma_x,
                              prng.generator(prng.fold_in(key, l),
                                             X_test.device))
    n = X_test.numel()
    sse = gaussian_sse(X_test, Z, A, active)
    ll = (-0.5 * n * ibm.LOG2PI - n * torch.log(sigma_x)
          - 0.5 * sse / sigma_x**2)
    return ll + ibm.z_prior_loglik(Z, pi, active)


def train_joint_loglik(X: Tensor, Z: Tensor, A: Tensor, pi: Tensor,
                       active: Tensor, sigma_x: Tensor) -> Tensor:
    """log P(X, Z | A, pi, sigma) on the training rows (monitoring)."""
    ll = ibm.uncollapsed_loglik(X, Z * active[None, :], A, sigma_x)
    return ll + ibm.z_prior_loglik(Z, pi, active)
