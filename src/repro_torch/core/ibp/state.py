"""Sampler state of the serial baselines, its initialization, and the
prior hyper-parameters.

Port of ``repro/core/ibp/state.py``. Tensors live on the caller's
device; ``key``, ``p_prime`` and ``it`` live on the host, as in
``HybridGlobal`` (``key`` is a uint32[2] tensor, see ``prng``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch import prng, tracing

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IBPHypers:
    """Fixed hyper-hyper parameters (priors)."""

    a_alpha: float = 1.0   # Gamma prior on alpha (shape)
    b_alpha: float = 1.0   # Gamma prior on alpha (rate)
    a_sx: float = 1.0      # InvGamma prior on sigma_x^2
    b_sx: float = 1.0
    a_sa: float = 1.0      # InvGamma prior on sigma_a^2
    b_sa: float = 1.0
    resample_sigmas: bool = True
    resample_alpha: bool = True


@dataclasses.dataclass
class IBPState:
    """State of a serial sampler. Feature-indexed buffers are padded to
    K_max; ``active`` marks instantiated (K+) features, ``tail`` the
    tail features of the reference's layout (unused by the port's
    baselines, carried for the reference's field set)."""

    Z: Tensor         # (N, K_max) float {0,1}
    A: Tensor         # (K_max, D)
    pi: Tensor        # (K_max,)
    active: Tensor    # (K_max,) float {0,1}
    tail: Tensor      # (K_max,) float {0,1}
    alpha: Tensor     # ()
    sigma_x: Tensor   # ()
    sigma_a: Tensor   # ()
    key: Tensor       # (2,) uint32, on the host
    p_prime: Tensor   # () int32, on the host
    it: Tensor        # () int32, on the host

    @property
    def k_plus(self) -> Tensor:
        return torch.sum(self.active).to(torch.int32)

    @property
    def k_max(self) -> int:
        return self.Z.shape[1]


def init_state(
    key: Tensor,
    N: int,
    D: int,
    K_max: int,
    alpha: float = 3.0,
    sigma_x: float = 1.0,
    sigma_a: float = 1.0,
    K_init: int = 1,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> IBPState:
    """K_init random features: Bernoulli(1/2) columns of Z, N(0, sigma_a^2)
    rows of A, on ``device`` (default ``cuda``; raises without a GPU)."""
    dev = _device.resolve(device)
    k0, k1, k2 = prng.split(key, 3)
    Z = torch.zeros((N, K_max), dtype=dtype, device=dev)
    A = torch.zeros((K_max, D), dtype=dtype, device=dev)
    if K_init > 0:
        Z[:, :K_init] = (torch.rand((N, K_init),
                                    generator=prng.generator(k0, dev),
                                    dtype=dtype, device=dev) < 0.5).to(dtype)
        A[:K_init] = torch.randn((K_init, D),
                                 generator=prng.generator(k1, dev),
                                 dtype=dtype, device=dev) * sigma_a
    active = torch.zeros((K_max,), dtype=dtype, device=dev)
    active[:K_init] = 1.0
    pi = torch.zeros((K_max,), dtype=dtype, device=dev)
    pi[:K_init] = 0.5
    with tracing.transfer("init", 3):
        alpha, sigma_x, sigma_a = (torch.tensor(v, dtype=dtype, device=dev)
                                   for v in (alpha, sigma_x, sigma_a))
    return IBPState(
        Z=Z, A=A, pi=pi, active=active,
        tail=torch.zeros((K_max,), dtype=dtype, device=dev),
        alpha=alpha, sigma_x=sigma_x, sigma_a=sigma_a,
        key=k2, p_prime=torch.tensor(0, dtype=torch.int32),
        it=torch.tensor(0, dtype=torch.int32),
    )
