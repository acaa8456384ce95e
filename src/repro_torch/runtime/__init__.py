from repro_torch.core.ibp.api import Sampler, SamplerSpec, build_sampler

from .driver import DriverConfig, MCMCDriver, as_spec

__all__ = [
    "MCMCDriver",
    "DriverConfig",
    "SamplerSpec",
    "Sampler",
    "build_sampler",
    "as_spec",
]
