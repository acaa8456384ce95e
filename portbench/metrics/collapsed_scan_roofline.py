"""`collapsed_scan`'s least time (portbench/work.py) over its device time in
the traced window, %."""
from portbench import readers


def read(facts):
    return readers.roofline(facts, "collapsed_scan")
