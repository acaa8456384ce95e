"""Small CPU runs of each cell's path for the tests: the cell's files
shrunk to a size a test run holds, and the faults the comparison must
catch, planted underneath the timed path."""
from __future__ import annotations

import copy
import dataclasses
import importlib
import time

import torch

from . import harness
from .run import load_cell

SMALL = {"cambridge-d36": dict(N=512, N_eval=32)}


def small_ctx(workload: str, seed: int, fault=None, control=False
              ) -> tuple[harness.Ctx, object]:
    """(context, runner) of ``workload`` on the CPU at a test's size."""
    harness.port_path()
    _, _, cfg, tr, limits = load_cell(workload)
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    cfg.update(SMALL[cfg["name"]])
    cfg["sampler"].update(P=4, K_max=8, K_tail=4)
    if tr["kind"] == "hybrid":
        tr.update(eval_every=2, warm_iters=1)
    if tr["kind"] == "uncollapsed":
        tr.update(read_every=2, warm_iters=1)
    ctx = harness.Ctx(workload=workload, cfg=cfg, traffic=tr, seed=seed,
                      seconds=0.0, trace=False, device=torch.device("cpu"),
                      t_start=time.perf_counter(), limits=limits,
                      fault=fault, control=control)
    return ctx, importlib.import_module(f"portbench.runners.{tr['kind']}")


def unchanged_step(target):
    """A step that returns its state unchanged."""
    if hasattr(target, "_s"):  # the hybrid driver's sampler
        target._s = _Same(target._s)
        return None
    return lambda st, X, hyp: st


class _Same:
    def __init__(self, s):
        self._s = s

    def __getattr__(self, name):
        return getattr(self._s, name)

    def step(self, gs, ss):
        return gs, ss


def dropped_sweeps(target):
    """A hybrid step that runs each of its sweeps and keeps its Z as it
    was: the sweep's result is recorded and dropped."""
    mod = importlib.import_module("repro_torch.core.ibp.hybrid")
    watch = mod.uncollapsed_sweep  # the recorder's, put back by its close

    def drop(X, Z, *args):
        watch(X, Z, *args)
        return Z

    mod.uncollapsed_sweep = drop


def half_rows(module: str):
    """Patch ``module``'s sweep to sweep the first half of the rows and
    keep the rest as they were; returns the undo."""
    mod = importlib.import_module(module)
    sweep = mod.uncollapsed_sweep

    def half(X, Z, A, pi, active, sigma_x, gen):
        n = Z.shape[0] // 2
        gens = gen if isinstance(gen, (list, tuple)) else [gen]
        Zn = sweep(X, Z, A, pi, active, sigma_x, gens)
        return torch.cat([Zn[:n], Z[n:]])

    mod.uncollapsed_sweep = half
    return lambda: setattr(mod, "uncollapsed_sweep", sweep)


def altered_sigma(target):
    """σ_x of each step's result moved by a relative 1e-3 where the step
    produces it."""
    if hasattr(target, "_s"):
        inner = target._s

        class _Alter:
            def __getattr__(self, name):
                return getattr(inner, name)

            def step(self, gs, ss):
                gs, ss = inner.step(gs, ss)
                return dataclasses.replace(
                    gs, sigma_x=gs.sigma_x * 1.001), ss

        target._s = _Alter()
        return None

    def step(st, X, hyp):
        st = target(st, X, hyp)
        return dataclasses.replace(st, sigma_x=st.sigma_x * 1.001)
    return step

