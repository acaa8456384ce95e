"""What every runner shares: the run's context, its outcome, the
benchmark's files by name, and the host clock."""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def now() -> float:
    return time.perf_counter()


def load_json(*parts: str) -> Any:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Ctx:
    """One run: the cell's configuration and traffic, the seed, the
    window, whether it is traced, the device, and the host clock's
    reading at process start."""

    workload: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    limits: dict
    fault: Any = None  # tests: a callable planting a fault in the program
    control: bool = False  # calibration: judge the TF32 control as well


@dataclasses.dataclass
class Outcome:
    """What a run measured: end-to-end values, the numbers compared,
    the facts the per-layer readers take, and the device's peak."""

    e2e: dict[str, float]
    numbers: dict[str, float]
    facts: dict[str, Any]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))


def cuda_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def port_path() -> None:
    """Put the program's package (``src/``) on the import path."""
    import sys
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
