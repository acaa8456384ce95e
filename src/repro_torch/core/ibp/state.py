"""Prior hyper-parameters of the sampler."""
from __future__ import annotations

import dataclasses


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
