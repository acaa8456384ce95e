from . import ops, ref
from .ops import feature_stats
from .ref import feature_stats_ref

__all__ = ["ops", "ref", "feature_stats", "feature_stats_ref"]
