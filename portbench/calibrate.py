"""Readings that set the limits of ``correct``.

    python -m portbench.calibrate --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds <s>

Runs the cell's window once a seed in this process (the set-up again
for each: the data and the program's state come from the seed) and
prints one JSON line a seed with the numbers ``check`` compares; on a
control seed also the numbers of the TF32 control (``reference``'s
float32 with every product's inputs rounded to TF32, in the program's
place), judged as the program is. The benchmark's own runs never run
the control. Needs a CUDA device, as a run does.
"""
from __future__ import annotations

import time

import argparse
import importlib
import json
import sys

from portbench import harness
from portbench.run import load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    _, w, cfg, traffic, limits = load_cell(args.workload)
    harness.port_path()
    import torch
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    runner = importlib.import_module(f"portbench.runners.{traffic['kind']}")
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, ctl in seeds:
        ctx = harness.Ctx(workload=args.workload, cfg=cfg, traffic=traffic,
                          seed=seed, seconds=args.seconds, trace=False,
                          device=dev, t_start=time.perf_counter(),
                          limits=limits, control=ctl)
        out = runner.run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "e2e": out.e2e, "attempted": out.attempted,
                          "numbers": out.numbers,
                          "control": out.facts.get("control")}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
