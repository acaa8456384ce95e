"""The uncollapsed Gibbs sweep, the hot loop of the hybrid sampler.

For every row n (data-parallel) and every instantiated feature k
(sequential: the likelihood couples features through the residual):

    P(Z_nk = 1 | pi_k, A, X_n) ∝ pi_k · N(X_n | Z_n A, sigma_x^2 I).

Port of ``repro/core/ibp/sweeps.py``. The sweep itself is the
``gibbs_flip`` kernel on CUDA tensors and its plain version on CPU
tensors; this module draws the logit-uniforms it consumes.
``sufficient_stats`` goes through the ``feature_stats`` kernel likewise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.feature_stats import feature_stats
from repro_torch.kernels.gibbs_flip import gibbs_flip_core

Tensor = torch.Tensor


def _logit(p: Tensor) -> Tensor:
    p = torch.clamp(p, 1e-6, 1.0 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def uncollapsed_sweep(X: Tensor, Z: Tensor, A: Tensor, pi: Tensor,
                      active: Tensor, sigma_x: Tensor,
                      gen: torch.Generator | list[torch.Generator]
                      ) -> Tensor:
    """One full Gibbs sweep of Z | pi, A over active columns. Returns new Z.

    Rows are independent, so any number of shards' rows can go through
    one call (the hybrid sampler sweeps all its shards at once). ``gen``
    is one generator, or a list of them: one per equal block of rows (a
    shard each), block i's uniforms drawn from ``gen[i]``, so a shard's
    draws do not depend on which other shards share the call.
    """
    # pre-drawn uniforms, in logit space so the accept test is logit > u
    gens = gen if isinstance(gen, (list, tuple)) else [gen]
    shape = (Z.shape[0] // len(gens), Z.shape[1])
    draws = [torch.rand(shape, generator=g, dtype=X.dtype, device=X.device)
             for g in gens]
    u = _logit(draws[0] if len(draws) == 1 else torch.cat(draws))
    inv2s2 = 0.5 / (sigma_x**2)
    return gibbs_flip_core(X, Z, A, _logit(pi), active, u, inv2s2)


def sufficient_stats(X: Tensor, Z: Tensor
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(m, ZtZ, ZtX, trXtX) of the rows of X (N, D) and Z (N, K)."""
    ZtZ, ZtX, m = feature_stats(X, Z)
    return m, ZtZ, ZtX, torch.sum(X * X)
