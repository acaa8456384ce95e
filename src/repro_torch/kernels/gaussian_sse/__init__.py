from . import ops, ref
from .ops import gaussian_sse
from .ref import gaussian_sse_ref

__all__ = ["ops", "ref", "gaussian_sse", "gaussian_sse_ref"]
