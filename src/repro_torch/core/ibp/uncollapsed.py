"""Fully uncollapsed Gibbs sampler (finite beta-Bernoulli approximation).

Port of ``repro/core/ibp/uncollapsed.py``: the paper's 'poor mixing'
baseline. Instantiate pi and A for a finite K truncation (Eq. 2), sweep
Z | pi, A with every column active, then conjugate draws for A, pi,
sigma_x, sigma_a and alpha. The sweep is the ``gibbs_flip`` kernel, the
statistics ``feature_stats`` and the residual ``gaussian_sse``, each on
CUDA tensors (their plain versions on CPU tensors).

The draws are the finite model's, not the hybrid sync's: pi ~
Beta(alpha/K + m, 1 + N - m), sigma_a's shape counts all K columns and
is not held at K+ = 0, and alpha's K+ counts the columns with m > 0.5.
"""
from __future__ import annotations

import torch

from repro_torch import prng, tracing
from repro_torch.kernels.feature_stats import feature_stats
from repro_torch.kernels.gaussian_sse import gaussian_sse

from . import math as ibm
from .state import IBPHypers, IBPState
from .sweeps import uncollapsed_sweep

Tensor = torch.Tensor


def uncollapsed_step(state: IBPState, X: Tensor,
                     hyp: IBPHypers) -> IBPState:
    """One iteration: Z | pi,A ; A | Z,X ; pi | Z ; hypers."""
    with tracing.span("iteration"):
        N, D = X.shape
        K = state.Z.shape[1]
        dev, dt = X.device, X.dtype
        active = torch.ones((K,), dtype=dt, device=dev)  # all K columns live
        key, kz, ka, kpi, ksx, ksa, kal = prng.split(state.key, 7)
        gen = lambda k: prng.generator(k, dev)  # noqa: E731

        with tracing.span("sweep"):
            Z = uncollapsed_sweep(X, state.Z, state.A, state.pi, active,
                                  state.sigma_x, gen(kz))
        with tracing.span("sync"):
            ZtZ, ZtX, m = feature_stats(X, Z)
            A = ibm.a_posterior_draw(gen(ka), ZtZ, ZtX, active,
                                     state.sigma_x, state.sigma_a)
            pi = ibm.beta_draw(gen(kpi), state.alpha / K + m, 1.0 + N - m)

            sigma_x, sigma_a, alpha = state.sigma_x, state.sigma_a, state.alpha
            if hyp.resample_sigmas:
                sse = gaussian_sse(X, Z, A, active)
                with tracing.transfer("sigma_shapes", 2):
                    shape_x, shape_a = (
                        torch.tensor(v, dtype=dt, device=dev)
                        for v in (hyp.a_sx + 0.5 * N * D,
                                  hyp.a_sa + 0.5 * K * D))
                sigma_x = torch.sqrt(ibm.inverse_gamma_draw(
                    gen(ksx), shape_x, hyp.b_sx + 0.5 * sse))
                sigma_a = torch.sqrt(ibm.inverse_gamma_draw(
                    gen(ksa), shape_a, hyp.b_sa + 0.5 * torch.sum(A * A)))
            if hyp.resample_alpha:
                k_plus = torch.sum(m > 0.5).to(dt)
                alpha = ibm.gamma_draw(gen(kal), hyp.a_alpha + k_plus,
                                       hyp.b_alpha + ibm.harmonic(N))

        return IBPState(
            Z=Z, A=A, pi=pi, active=active, tail=state.tail,
            alpha=alpha, sigma_x=sigma_x, sigma_a=sigma_a, key=key,
            p_prime=state.p_prime, it=state.it + 1,
        )
