"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use, every
kernel library that is missing is compiled by its own ``nvcc`` process,
all started together, into ``build/repro_torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``), and loaded with ``ctypes``. A
library's file name carries a hash of its sources and flags, so an edited
source rebuilds. ``nvcc`` missing or a failed build raises: there is no
fallback to the plain versions on a CUDA tensor.

No ``--use_fast_math``: ``log``, ``log1p`` and ``exp`` feed accept/reject
decisions.

Every wrapper counts its launches in a ``LaunchCounter`` registered here,
so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
KERNELS = ("gibbs_flip", "collapsed_row", "collapsed_scan", "gaussian_sse",
           "feature_stats")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Launches of one kernel; its wrapper adds one per kernel launch."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


_COUNTERS: dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return _COUNTERS.setdefault(name, LaunchCounter(name))


def launch_counts() -> dict[str, int]:
    return {n: c.launches for n, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.launches = 0


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch cannot be "
        "built; run on a machine with the CUDA toolkit, or pass "
        "device='cpu' for the plain PyTorch path"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    each, in parallel. Returns ``{name: compiler output}`` for what was
    built (``-Xptxas -v``: registers, shared memory, spills)."""
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n, tgt in todo:
        tmp = tgt.with_name(f"{tgt.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tgt, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for n, tgt, tmp, p in procs:
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (exit {p.returncode}):"
                          f"\n{out}")
        else:
            os.replace(tmp, tgt)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    build((name,))
    return ctypes.CDLL(str(_target(name)))


def function(name: str, symbol: str, argtypes: list,
             restype=ctypes.c_int):
    """The C function ``symbol`` of kernel library ``name`` (built on
    first use), with its argument and result types declared."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(rc: int, name: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
