from . import convergence, predict
from .api import Sampler, SamplerSpec, build_sampler
from .hybrid import HybridGlobal, HybridShard, init_hybrid
from .state import IBPHypers
from .sweeps import uncollapsed_sweep

__all__ = [
    "IBPHypers",
    "uncollapsed_sweep",
    "HybridGlobal",
    "HybridShard",
    "init_hybrid",
    "Sampler",
    "SamplerSpec",
    "build_sampler",
    "convergence",
    "predict",
]
