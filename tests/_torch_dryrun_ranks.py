"""Rank functions of the dry-run tests (``test_torch_dryrun.py``), run by
``repro_torch.parallel.spawn`` on real gloo ranks of the CPU. JAX-free:
every rank imports this module.

Each runs a step for real, as ``launch/dryrun.py`` builds it, and
returns the collectives it made (``dryrun.collectives()``: by kind,
count, bytes and group), which the parent holds against the dry run of
the same step on fake tensors in a fake world.
"""
from __future__ import annotations

import torch

from repro_torch import parallel
from repro_torch.configs import ShapeConfig
from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
from repro_torch.data import cambridge_data
from repro_torch.launch import dryrun


def lm_cells(cases: list) -> list:
    """Each (config, shape kwargs, mesh sizes, axis names) case's step on
    real CPU tensors (``build_step`` outside a ``FakeTensorMode``, its
    weights uninitialised): its collectives."""
    out = []
    for cfg, kw, sizes, names in cases:
        mesh = parallel.make_mesh(sizes, names)
        step, args = dryrun.build_step(cfg, ShapeConfig(**kw), mesh,
                                       device="cpu")
        parallel.reset_collective_counts()
        step(*args)
        out.append(dryrun.collectives())
    return out


def ibp_cells(N: int, spec_kw: dict, syncs: tuple) -> list:
    """One iteration of the data-parallel sampler (P = the world's
    ranks) on Cambridge data under each sync: its collectives."""
    X = cambridge_data(N=N, seed=0)[0]
    P = parallel.world().size
    out = []
    for sync in syncs:
        s = build_sampler(SamplerSpec(P=P, data="shardmap", sync=sync,
                                      **spec_kw), IBPHypers(), X,
                          device="cpu")
        gs, ss = s.init()
        parallel.reset_collective_counts()
        s.step(gs, ss)
        out.append(dryrun.collectives())
    return out


def gathers_whole() -> bool:
    """On a (1, 2, 2) ("pod", "data", "model") mesh of the 4 ranks: a
    tensor sliced by specs that split a dim over a run of axes, and over
    runs and single axes together, gathered back whole."""
    mesh = parallel.make_mesh((1, 2, 2), ("pod", "data", "model"))
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    specs = [(("pod", "data"),), (("data", "model"),),
             (("pod", "data"), "model"), ("model", ("pod", "data"))]
    return all(torch.equal(parallel.gather_tensor(
        parallel.shard_tensor(t, s, mesh), s, mesh), t) for s in specs)


def cells(lm_cases: list, N: int, spec_kw: dict, syncs: tuple
          ) -> tuple[list, list, bool]:
    """``lm_cells``, ``ibp_cells`` and ``gathers_whole``, in one group."""
    return (lm_cells(lm_cases), ibp_cells(N, spec_kw, syncs),
            gathers_whole())
