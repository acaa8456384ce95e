"""Device ms of the hybrid tail (`collapsed_scan`) an iteration."""
from portbench import readers


def read(facts):
    return readers.per_iter_ms(facts, "collapsed_scan")
