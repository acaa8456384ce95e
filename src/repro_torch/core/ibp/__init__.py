from . import convergence, predict
from .api import Sampler, SamplerSpec, build_sampler
from .collapsed import collapsed_sweep
from .hybrid import HybridGlobal, HybridShard, init_hybrid
from .predict import BankBuilder, SampleBank, make_sharded_scorer
from .state import IBPHypers, IBPState, init_state
from .sweeps import sufficient_stats, uncollapsed_sweep
from .uncollapsed import uncollapsed_step

__all__ = [
    "IBPHypers",
    "IBPState",
    "init_state",
    "uncollapsed_sweep",
    "sufficient_stats",
    "uncollapsed_step",
    "collapsed_sweep",
    "HybridGlobal",
    "HybridShard",
    "init_hybrid",
    "Sampler",
    "SamplerSpec",
    "build_sampler",
    "SampleBank",
    "BankBuilder",
    "make_sharded_scorer",
    "convergence",
    "predict",
]
