"""Linear-Gaussian IBP math: conjugate posteriors, likelihoods, draws.

Port of ``repro/core/ibp/math.py`` (the parts the hybrid sampler and
the serial baselines run).
Model (paper Eq. 1):

    X = Z A + eps,   eps ~ N(0, sigma_x^2 I),   A_k ~ N(0, sigma_a^2 I)

Feature-indexed buffers are padded to a static ``K_max``; an ``active``
mask (float {0,1}) selects live columns. The padded W, its Cholesky
inverse, the rank-one Cholesky moves, the G = HHᵀ move ``g_rank1`` and the
packed block's column choice ``block_select`` live in
``repro_torch.linalg`` and are re-exported here under the reference's
names.

Draws take an explicit ``torch.Generator`` on the tensors' device.
Gamma draws use ``torch._standard_gamma`` (``torch.distributions``
takes no generator).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.linalg import (  # noqa: F401  (the reference's names)
    _cholesky,
    _eye,
    block_select,
    chol_inv,
    chol_inv_logdet,
    chol_rank1_downdate,
    chol_rank1_downdate_t,
    chol_rank1_update,
    chol_rank1_update_t,
    g_rank1,
    mask_outer,
    padded_W,
)

Tensor = torch.Tensor

LOG2PI = math.log(2.0 * math.pi)


def a_posterior(ZtZ: Tensor, ZtX: Tensor, active: Tensor, sigma_x: Tensor,
                sigma_a: Tensor) -> tuple[Tensor, Tensor]:
    """Posterior of A | Z, X: mean = M Z^T X, per-column covariance
    sigma_x^2 M. Returns (mean (K,D) masked, M (K,K) masked)."""
    ratio = (sigma_x / sigma_a) ** 2
    W = padded_W(ZtZ, active, ratio)
    M, _ = chol_inv_logdet(W)
    M = M * mask_outer(active)
    mean = (M @ (ZtX * active[:, None])) * active[:, None]
    return mean, M


def a_posterior_draw(gen: torch.Generator, ZtZ: Tensor, ZtX: Tensor,
                     active: Tensor, sigma_x: Tensor,
                     sigma_a: Tensor) -> Tensor:
    """Draw A ~ P(A | Z, X). Columns of A are iid N(mean_d, sigma_x^2 M)."""
    mean, M = a_posterior(ZtZ, ZtX, active, sigma_x, sigma_a)
    K, D = ZtX.shape
    L = _cholesky(M + _eye(K, M) * (1.0 - active))
    eps = torch.randn((K, D), generator=gen, dtype=ZtX.dtype,
                      device=ZtX.device)
    return mean + sigma_x * ((L @ eps) * active[:, None])


def collapsed_loglik(
    trXtX: Tensor,
    ZtX: Tensor,
    ZtZ: Tensor,
    active: Tensor,
    N: Tensor | float,
    D: int,
    sigma_x: Tensor,
    sigma_a: Tensor,
) -> Tensor:
    """log P(X | Z) with A integrated out (paper Sec. 2 / G&G 2011 Eq. 26).

    log P = -(N D / 2) log(2 pi) - (N - K) D log sigma_x - K D log sigma_a
            - (D/2) log|W| - (1 / 2 sigma_x^2) ( tr(X^T X) - tr(X^T Z M Z^T X) )
    with W = Z^T Z + (sigma_x^2/sigma_a^2) I,  M = W^{-1}; feature inputs
    padded to K_max and masked by ``active``. Float32, with the
    reference's terms in the reference's order: at N D ~ 10^7 the terms
    are ~10^7 and a difference of two log-likelihoods carries rounding of
    order 1, in the reference as here.
    """
    ratio = (sigma_x / sigma_a) ** 2
    K = torch.sum(active)
    W = padded_W(ZtZ, active, ratio)
    M, logdetW = chol_inv_logdet(W)
    ZtX_m = ZtX * active[:, None]
    quad = torch.sum((M @ ZtX_m) * ZtX_m)  # tr( (ZtX)^T M (ZtX) )
    Nf = torch.as_tensor(N, dtype=torch.float32, device=ZtX.device)
    return (
        -0.5 * Nf * D * LOG2PI
        - (Nf - K) * D * torch.log(sigma_x)
        - K * D * torch.log(sigma_a)
        - 0.5 * D * logdetW
        - 0.5 / (sigma_x**2) * (trXtX - quad)
    )


def live_buckets(K_max: int, base: int = 8) -> tuple[int, ...]:
    """Power-of-two packed block sizes (8, 16, 32, ...) below K_max, then
    K_max itself, so a chain at full occupancy runs the full width."""
    if K_max < 1:
        raise ValueError(f"K_max={K_max} must be >= 1")
    bs = []
    b = base
    while b < K_max:
        bs.append(b)
        b *= 2
    bs.append(K_max)
    return tuple(bs)


def pick_bucket(buckets: tuple[int, ...], k_plus: int, headroom: int) -> int:
    """Smallest bucket with room for ``k_plus`` live features plus
    ``headroom`` free slots (so a row's births, j <= J_MAX, fit without a
    repack); the largest bucket (K_max) when none has, where a birth can
    never overflow the block."""
    for b in buckets:
        if b >= k_plus + headroom:
            return b
    return buckets[-1]


def sm_downdate(M: Tensor, z: Tensor) -> tuple[Tensor, Tensor]:
    """Sherman-Morrison removal: M' = (W - z z^T)^{-1} given M = W^{-1}.

    Returns (M', log det(W - z z^T) - log det W) = (M', log(1 - z^T M z)).
    """
    Mz = M @ z
    denom = 1.0 - torch.dot(z, Mz)
    return M + torch.outer(Mz, Mz) / denom, torch.log(denom)


def sm_update(M: Tensor, z: Tensor) -> tuple[Tensor, Tensor]:
    """Sherman-Morrison addition: M' = (W + z z^T)^{-1}; logdet delta =
    log(1 + z^T M z)."""
    Mz = M @ z
    denom = 1.0 + torch.dot(z, Mz)
    return M - torch.outer(Mz, Mz) / denom, torch.log(denom)


def uncollapsed_loglik(X: Tensor, Z: Tensor, A: Tensor,
                       sigma_x: Tensor) -> Tensor:
    """log N(X | Z A, sigma_x^2 I), summed over all entries."""
    R = X - Z @ A
    n = X.numel()
    return (-0.5 * n * LOG2PI - n * torch.log(sigma_x)
            - 0.5 * torch.sum(R * R) / sigma_x**2)


def z_prior_loglik(Z: Tensor, pi: Tensor, active: Tensor) -> Tensor:
    """sum_k sum_n log Bernoulli(Z_nk | pi_k) over active features."""
    p = torch.clamp(pi, 1e-6, 1.0 - 1e-6)
    ll = Z * torch.log(p)[None, :] + (1.0 - Z) * torch.log1p(-p)[None, :]
    return torch.sum(ll * active[None, :])


@functools.cache
def harmonic(N: int) -> float:
    return float(sum(1.0 / i for i in range(1, N + 1)))


def gamma_draw(gen: torch.Generator, shape_param: Tensor,
               rate_param: Tensor | float) -> Tensor:
    """X ~ Gamma(shape, rate)."""
    return torch._standard_gamma(shape_param, generator=gen) / rate_param


def inverse_gamma_draw(gen: torch.Generator, shape_param: Tensor,
                       rate_param: Tensor | float) -> Tensor:
    """X ~ InvGamma(a, b) via 1 / Gamma(a, rate=b)."""
    return 1.0 / gamma_draw(gen, shape_param, rate_param)


def beta_draw(gen: torch.Generator, a: Tensor, b: Tensor) -> Tensor:
    """X ~ Beta(a, b) from two Gamma draws."""
    ga = torch._standard_gamma(a, generator=gen)
    gb = torch._standard_gamma(b, generator=gen)
    return ga / (ga + gb)
