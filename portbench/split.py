"""A cell's traced window with its device idle time split by the
program's spans.

    python -m portbench.split --workload <name> --seed <n> [--seconds s]

Runs the window as ``portbench.run --trace 1`` does (the cell's runner
under the profiler, ``--seconds`` capped by the traffic's
``trace_seconds``) and prints one JSON line: the device idle ms an
iteration (step) under each layer's spans (``spans.summarize``; the
``sync`` layer holds ``sync`` and ``eval``), the part no span covers,
the window's idle ms by ``devtrace`` and the split's coverage of it,
the launch check (``spans.launches_in_spans``), the host syncs an
iteration by span and operation (``spans.syncs_in_spans``), the
program's counters, the last tail's scan run again under
``tracing.recording()`` (cycles by phase, rows, each phase's share of
the launch's cycles), every per-layer metric of the cell, and
``correct``. Needs a CUDA device, as a run does.

The runners hand the profiler's record to ``devtrace.summarize`` alone;
this tool wraps that function in its own process to see the record.
Once the runners put ``spans.summarize(prof, tracing.profiled())``
under ``facts["spans"]`` and the idle split has a reader a layer, this
tool, its wrapping and ``tracing``'s record kept under the profiler go
together.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import check, devtrace, harness, spans  # noqa: E402
from portbench.run import load_cell, metrics_of, read_metric  # noqa: E402

# kernel (part of its name) -> the spans that launch it
LAUNCHED_IN = {"gibbs_flip": ("sweep", "eval"), "collapsed_scan": ("tail",)}
# each layer's idle metric (<layer>_idle_ms) by the span names it reads
IDLE_LAYERS = {"driver": ("driver",), "iter": ("iteration",),
               "sweep": ("sweep",), "tail": ("tail",),
               "sync": ("sync", "eval")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    bench, w, cfg, traffic, limits = load_cell(args.workload)
    harness.port_path()
    import torch
    from repro_torch import tracing
    if not torch.cuda.is_available():
        print("portbench.split: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    runner = importlib.import_module(f"portbench.runners.{traffic['kind']}")
    seen = {}
    summarize = devtrace.summarize

    def keep(prof, window_s):
        rec = tracing.profiled()
        seen["split"] = spans.summarize(prof, rec)
        seen["launches"] = {k: spans.launches_in_spans(prof, rec, k, v)
                            for k, v in LAUNCHED_IN.items()}
        seen["syncs"] = spans.syncs_in_spans(prof, rec)
        return summarize(prof, window_s)

    devtrace.summarize = keep
    try:
        ctx = harness.Ctx(workload=args.workload, cfg=cfg, traffic=traffic,
                          seed=args.seed, seconds=args.seconds, trace=True,
                          device=dev, t_start=T_START, limits=limits)
        out = runner.run(ctx)
    finally:
        devtrace.summarize = summarize
    iters = out.facts["iters"]
    split, t = seen["split"], out.trace
    by = split["by_span"]
    layers = {f"{k}_idle_ms": sum(by.get(n, 0.0) for n in names) / iters
              for k, names in IDLE_LAYERS.items()}
    idle_ms = 1e3 * (t["window_s"] - t["busy_s"]) / iters
    rec = tracing.profiled()
    rep = rec.replayed("tail")
    scan = None
    if rep is not None and rep.scan["total"]:
        scan = dict(rep.scan, share={
            p: 100.0 * rep.scan[p] / rep.scan["total"]
            for p in ("move", "refresh", "flip", "birth")})
    line = {
        "workload": args.workload, "seed": args.seed, "iters": iters,
        "device": torch.cuda.get_device_name(dev),
        "correct": check.held(out.numbers, limits)[0],
        "idle_ms": layers,
        "uncovered_ms": split["uncovered_ms"] / iters,
        "split_idle_ms": split["idle_ms"] / iters,
        "devtrace_idle_ms": idle_ms,
        "coverage": sum(layers.values()) / idle_ms,
        "launches": seen["launches"],
        "syncs": {k: v / iters for k, v in seen["syncs"].items()},
        "counters": {k: v / iters for k, v in sorted(rec.counters.items())},
        "scan": scan,
        "metrics": {m["name"]: read_metric(m["name"], out.facts)
                    for m in metrics_of(bench, args.workload, True)},
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
