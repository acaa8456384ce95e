"""The LM's mesh rules for launchers (a re-export of
``repro_torch.parallel.mesh``): ``mesh_axes`` and the resolvers of
parameter, activation, batch and cache specs, on a rank's
``parallel.Mesh`` or a shape-only ``mesh_shape``."""
from repro_torch.parallel.mesh import (
    HBM_BYTES,
    SERVE_WEIGHT_BUDGET,
    MeshShape,
    act_specs,
    batch_specs,
    cache_specs,
    layer_cache_specs,
    mesh_axes,
    mesh_shape,
    resolve_param_specs,
    resolve_shardings,
)

__all__ = [
    "HBM_BYTES",
    "SERVE_WEIGHT_BUDGET",
    "MeshShape",
    "act_specs",
    "batch_specs",
    "cache_specs",
    "layer_cache_specs",
    "mesh_axes",
    "mesh_shape",
    "resolve_param_specs",
    "resolve_shardings",
]
