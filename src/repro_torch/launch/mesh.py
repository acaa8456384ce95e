"""The LM's mesh rules for launchers (a re-export of
``repro_torch.parallel.mesh``): the production meshes of H100 clusters
(``make_production_mesh``: (32, 8) ("data", "model"), 256 cards;
``multi_pod=True``: (2, 32, 8) ("pod", "data", "model"), 512 cards; shape
only, so importing this touches no device), ``mesh_axes`` and the
resolvers of parameter, activation, batch and cache specs, on a rank's
``parallel.Mesh`` or a shape-only ``mesh_shape``."""
from repro_torch.parallel.mesh import (
    HBM_BYTES,
    SERVE_WEIGHT_BUDGET,
    MeshShape,
    act_specs,
    batch_specs,
    cache_specs,
    layer_cache_specs,
    make_production_mesh,
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
    "make_production_mesh",
    "mesh_axes",
    "mesh_shape",
    "resolve_param_specs",
    "resolve_shardings",
]
