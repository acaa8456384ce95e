"""The summed least times of an iteration's kernels over its wall
time, %; a serial step's as ``iter_mfu.step``."""
from portbench import readers


def read(facts):
    return readers.mfu(facts)
