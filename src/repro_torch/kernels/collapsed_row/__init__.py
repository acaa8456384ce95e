from . import ops, ref
from .ops import collapsed_row_flip
from .ref import collapsed_row_flip_ref

__all__ = ["ops", "ref", "collapsed_row_flip", "collapsed_row_flip_ref"]
