"""Device ms an iteration of every kernel but the sweep and the tail:
the master sync, its draws and the eval; a serial step's statistics,
residual and draws as ``sync_ms.step``."""
from portbench import readers


def read(facts):
    t = facts.get("trace")
    if t is None:
        return None
    other = sum(t["kernel_s"].values())
    for k in ("gibbs_flip", "collapsed_scan"):
        other -= readers.kernel_s(facts, k) or 0.0
    return 1e3 * other / facts["iters"]
