"""`gibbs_flip`'s least time (portbench/work.py) over its device time in
the traced window, %; the serial step reads it as
``gibbs_flip_roofline.step``."""
from portbench import readers


def read(facts):
    return readers.roofline(facts, "gibbs_flip")
