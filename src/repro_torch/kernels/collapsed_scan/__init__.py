from . import ops, ref
from .ops import collapsed_scan
from .ref import collapsed_scan_ref

__all__ = ["ops", "ref", "collapsed_scan", "collapsed_scan_ref"]
