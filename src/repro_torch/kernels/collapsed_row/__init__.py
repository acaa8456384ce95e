from . import fast, ops, ref
from .fast import collapsed_row_flip_fast
from .ops import collapsed_row_flip
from .ref import collapsed_row_flip_ref

__all__ = ["fast", "ops", "ref", "collapsed_row_flip",
           "collapsed_row_flip_fast", "collapsed_row_flip_ref"]
