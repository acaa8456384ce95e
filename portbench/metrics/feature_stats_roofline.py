"""`feature_stats`'s least time (portbench/work.py) over its device time in
the traced window, %; the serial step reads it as
``feature_stats_roofline.step``."""
from portbench import readers


def read(facts):
    return readers.roofline(facts, "feature_stats")
