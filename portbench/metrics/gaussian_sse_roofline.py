"""`gaussian_sse`'s least time (portbench/work.py) over its device time in
the traced window, %; the serial step reads it as
``gaussian_sse_roofline.step``."""
from portbench import readers


def read(facts):
    return readers.roofline(facts, "gaussian_sse")
