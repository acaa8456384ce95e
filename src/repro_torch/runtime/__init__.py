from repro_torch.core.ibp.api import Sampler, SamplerSpec, build_sampler

from .driver import MCMCDriver

__all__ = ["MCMCDriver", "SamplerSpec", "Sampler", "build_sampler"]
