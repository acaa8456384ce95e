"""The program's host transfers (its ``host_transfers.<site>``
counters: ``float``, ``int``, ``.cpu()``, ``torch.tensor(...,
device=)``) an iteration, read as ``host_transfers.sample``, or a
serial step as ``host_transfers.step``."""
from portbench import spans


def read(facts):
    rec = spans.record(facts)
    if rec is None:
        return None
    n = sum(v for k, v in rec.counters.items()
            if k.startswith("host_transfers."))
    return n / facts["iters"]
