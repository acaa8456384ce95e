"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic, limits
and per-layer readers are found by name under ``portbench/``; the
traffic's ``kind`` names the runner. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` runs its window under the profiler and
reports its per-layer metrics. Without a CUDA device, or with fewer
than the cell asks for, it exits with code 3 and prints no result.
Build caches stay inside the checkout (``build/``), at fixed paths.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import check, harness  # noqa: E402


def cell_of(bench: dict, workload: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return w, cfg


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list it, or list no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metric(name: str, facts: dict):
    """The metric's reader, ``metrics/<name>.py``; where there is none,
    the reader of the quantity, ``metrics/<name before its first
    dot>.py`` (``sweep_ms.step`` reads as ``sweep_ms``)."""
    path = os.path.join(harness.HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(harness.HERE, "metrics",
                            f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(facts)


def load_cell(workload: str) -> tuple[dict, dict, dict, dict, dict]:
    """(BENCHMARK.json, its cell, the configuration, the traffic, the
    limits) of ``workload``."""
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    w, c = cell_of(bench, workload)
    cfg = harness.load_json(harness.ROOT, c["file"])
    traffic = harness.load_json(harness.HERE, "traffic",
                                f"{w['traffic']}.json")
    return bench, w, cfg, traffic, check.load_limits(workload)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, w, cfg, traffic, limits = load_cell(args.workload)
    build = os.path.join(harness.ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    harness.port_path()
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: the program is not here ({e}); no result",
              file=sys.stderr)
        return 5
    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < w["chips"]:
        print(f"portbench: {w['chips']} CUDA device(s) needed, {seen} "
              f"visible; no result", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    runner = importlib.import_module(f"portbench.runners.{traffic['kind']}")
    ctx = harness.Ctx(workload=args.workload, cfg=cfg, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=dev, t_start=T_START,
                      limits=limits)
    out = runner.run(ctx)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 4
    ok, rows = check.held(out.numbers, limits)
    metrics = {}
    for m in metrics_of(bench, args.workload, bool(args.trace)):
        v = (out.e2e.get(m["name"]) if not args.trace
             else read_metric(m["name"], out.facts))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": w["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": ok, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    sys.stdout.flush()
    for n, v, lim in rows:
        print(f"check {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
