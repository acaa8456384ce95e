"""CUDA runtime calls that wait for the device, an iteration or serial
step: read as ``host_syncs.sample`` and ``host_syncs.step``."""


def read(facts):
    t = facts.get("trace")
    return None if t is None else t["syncs"] / facts["iters"]
