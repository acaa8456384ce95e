"""Rank functions of the chains x data mesh tests (``test_torch_mesh.py``),
run by ``repro_torch.parallel.spawn`` in processes of their own.
JAX-free: every rank imports this module.

Each function runs on every rank of the group and returns numpy arrays
and plain values, which the parent compares across ranks, with the
single-process layouts and with the reference.
"""
from __future__ import annotations

import numpy as np
from _torch_cases import bank_samples
from _torch_shardmap_ranks import gs_arrays

from repro_torch import parallel, prng
from repro_torch.core.ibp import (
    BankBuilder,
    HybridShard,
    IBPHypers,
    SamplerSpec,
    build_sampler,
    make_sharded_scorer,
)
from repro_torch.core.ibp import hybrid as thy
from repro_torch.data import cambridge_data


def _counts() -> dict:
    """The collectives since the last reset: over the chain axis, the data
    axis, and in all."""
    return {g: parallel.collective_counts(g)
            for g in ("chains", "data", None)}


def _canonical(s, gs, ss) -> dict:
    """The canonical state of every rank (collectives): Z (C, P, N_p, K),
    its tails, and the chain-batched HybridGlobal."""
    c = s.to_canonical(ss)
    return {"Z": c.Z.numpy(), "Z_tail": c.Z_tail.numpy(),
            "tail_active": c.tail_active.numpy(),
            "gs": gs_arrays(s.to_canonical_global(gs))}


def mesh_run(N: int, data_seed: int, spec_kw: dict, key: int,
             iters: int) -> dict:
    """``iters`` steps of a chains="mesh" sampler from ``init(key)``, then
    a stale pass: after each step the rank's own HybridGlobal and the
    collectives the step made by group; the stale pass's collectives;
    the canonical state after the steps and after the stale pass."""
    X, _, _ = cambridge_data(N=N, sigma_n=0.4, seed=data_seed)
    s = build_sampler(SamplerSpec(chains="mesh", **spec_kw), IBPHypers(), X,
                      device="cpu")
    gs, ss = s.init(prng.key(key))
    steps = []
    for _ in range(iters):
        parallel.reset_collective_counts()
        gs, ss = s.step(gs, ss)
        steps.append({"gs": gs_arrays(gs), "counts": _counts()})
    after_steps = _canonical(s, gs, ss)
    parallel.reset_collective_counts()
    gs, ss = s.stale(gs, ss)
    stale_counts = _counts()
    return {"coords": s.mesh.coords, "steps": steps, "step": after_steps,
            "stale_counts": stale_counts, "stale": _canonical(s, gs, ss)}


def against_shardmap(N: int, data_seed: int, spec_kw: dict, key: int,
                     iters: int) -> dict:
    """The mesh of one chain and the chainless shardmap layout, both on
    this group, stepped ``iters`` times from the shardmap layout's
    ``init(key)`` (lifted to a chain of one), then a stale pass each;
    both canonical states after the steps and after the stale pass."""
    X, _, _ = cambridge_data(N=N, sigma_n=0.4, seed=data_seed)
    hyp = IBPHypers()
    c = build_sampler(SamplerSpec(chains="mesh", data="shardmap", n_chains=1,
                                  **spec_kw), hyp, X, device="cpu")
    d = build_sampler(SamplerSpec(data="shardmap", **spec_kw), hyp, X,
                      device="cpu")
    gd, sd = d.init(prng.key(key))
    sd_c = d.to_canonical(sd)
    gc = c.from_canonical_global(thy.stack_chains([gd]))
    sc = c.from_canonical(HybridShard(*(t[None] for t in (
        sd_c.Z, sd_c.Z_tail, sd_c.tail_active))))
    for _ in range(iters):
        gc, sc = c.step(gc, sc)
        gd, sd = d.step(gd, sd)
    out = {"mesh": _canonical(c, gc, sc), "shardmap": _canonical(d, gd, sd)}
    gc, sc = c.stale(gc, sc)
    gd, sd = d.stale(gd, sd)
    out["mesh_stale"] = _canonical(c, gc, sc)
    out["shardmap_stale"] = _canonical(d, gd, sd)
    return out


def sharded_score(bank_kw: dict, X: np.ndarray, key: int, n_sweeps: int,
                  bad_rows: int) -> dict:
    """``make_sharded_scorer`` over a ("data",) mesh of this group on a
    bank of ``bank_samples(**bank_kw)``: the scores of X, and the error
    of a batch of ``bad_rows`` rows (None if it scored)."""
    b = BankBuilder(bank_kw["K_max"])
    for kw in bank_samples(**bank_kw):
        b.add(**kw)
    mesh = parallel.make_mesh((parallel.world().size,), ("data",))
    score = make_sharded_scorer(b.build("cpu"), mesh, n_sweeps=n_sweeps)
    out = {"scores": score(X, prng.key(key)).numpy(), "bad": None}
    try:
        score(X[:bad_rows], prng.key(key))
    except ValueError as e:
        out["bad"] = str(e)
    return out

