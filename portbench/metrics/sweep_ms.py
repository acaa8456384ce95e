"""Device ms of the sweep (`gibbs_flip`) a sampler iteration, or a
serial step as ``sweep_ms.step``."""
from portbench import readers


def read(facts):
    return readers.per_iter_ms(facts, "gibbs_flip")
