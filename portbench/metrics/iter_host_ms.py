"""Host ms of an ``iteration`` span less the host transfers inside it
(where the host waits for the device), the mean over the traced window:
the host's time to enqueue one hybrid iteration; a serial step's as
``iter_host_ms.step``."""
from portbench import spans


def read(facts):
    return spans.host_ms(facts, "iteration")
