"""Rank functions of the data-parallel tests (``test_torch_shardmap.py``,
``test_torch_driver.py``), run by ``repro_torch.parallel.spawn`` in
processes of their own. JAX-free: every rank imports this module.

Each function runs on every rank of the group and returns numpy arrays
and plain values, which the parent compares across ranks and with the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import parallel, prng
from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
from repro_torch.core.ibp import hybrid as thy
from repro_torch.data import cambridge_data


def gs_arrays(gs) -> dict[str, np.ndarray]:
    return {k: v.cpu().numpy().copy() for k, v in vars(gs).items()}


def converge(N: int, data_seed: int, spec_kw: dict, key: int,
             iters: int) -> dict:
    """``iters`` steps from ``init(key)``; the HybridGlobal after each."""
    X, _, _ = cambridge_data(N=N, seed=data_seed)
    s = build_sampler(SamplerSpec(data="shardmap", **spec_kw), IBPHypers(),
                      X, device="cpu")
    gs, ss = s.init(prng.key(key))
    steps = []
    for _ in range(iters):
        gs, ss = s.step(gs, ss)
        steps.append(gs_arrays(gs))
    return {"steps": steps, "Z": s.to_canonical(ss).Z.numpy()}


def against_vmap(N: int, data_seed: int, spec_kw: dict, key: int,
                 iters: int) -> dict:
    """The vmap layout (this process, one device) and the shardmap layout
    stepped from one canonical state and key, with the collectives and
    the SSE reductions each step made, and the HybridGlobal after each
    shardmap step."""
    X, _, _ = cambridge_data(N=N, seed=data_seed)
    hyp = IBPHypers()
    spec = SamplerSpec(data="shardmap", **spec_kw)
    sv = build_sampler(spec.replace(data="vmap", sync="staged"), hyp, X,
                       device="cpu")
    sm = build_sampler(spec, hyp, X, device="cpu")
    gs_v, st_v = sv.init(prng.key(key))
    gs_s, st_s = gs_v, sm.from_canonical(sv.to_canonical(st_v))
    sse_calls = [0]
    sse = thy.gaussian_sse

    def counted_sse(*a):
        sse_calls[0] += 1
        return sse(*a)

    thy.gaussian_sse = counted_sse
    steps, counts, sses = [], [], []
    try:
        for _ in range(iters):
            gs_v, st_v = sv.step(gs_v, st_v)
            parallel.reset_collective_counts()
            sse_calls[0] = 0
            gs_s, st_s = sm.step(gs_s, st_s)
            counts.append(parallel.collective_counts()["all_reduce_sum"])
            sses.append(sse_calls[0])
            steps.append(gs_arrays(gs_s))
    finally:
        thy.gaussian_sse = sse
    return {"vmap": gs_arrays(gs_v), "vmap_Z": st_v.Z.numpy(),
            "Z": sm.to_canonical(st_s).Z.numpy(), "steps": steps,
            "all_reduces": counts, "sse_calls": sses}


def stale_pass(N: int, spec_kw: dict, key: int) -> dict:
    """One stale pass under shardmap and under vmap from one state: the
    collectives it made, and both results."""
    X, _, _ = cambridge_data(N=N, seed=2)
    spec = SamplerSpec(data="shardmap", **spec_kw)
    sv = build_sampler(spec.replace(data="vmap", sync="staged"),
                       IBPHypers(), X, device="cpu")
    sm = build_sampler(spec, IBPHypers(), X, device="cpu")
    gs, st_v = sv.init(prng.key(key))
    gs, st_v = sv.step(gs, st_v)  # a live tail and state to carry on
    st_s = sm.from_canonical(st_v)
    parallel.reset_collective_counts()
    g_s, s_s = sm.stale(gs, st_s)
    counts = parallel.collective_counts()
    g_v, s_v = sv.stale(gs, st_v)
    c = sm.to_canonical(s_s)
    return {"counts": counts, "gs": gs_arrays(g_s), "gs_vmap": gs_arrays(g_v),
            "shard": [t.numpy() for t in (c.Z, c.Z_tail, c.tail_active)],
            "vmap": [t.numpy() for t in (s_v.Z, s_v.Z_tail, s_v.tail_active)]}


def sync_parts(case: dict) -> dict:
    """The syncs' reductions on rank p's block of a seeded case (numpy
    (P, ...) arrays): the staged schedule's tail mask, post-promotion
    statistics and SSE, the fused payload, and the SSE identity on it."""
    p = parallel.world().rank
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    X_p, Z, Zt = t["X"][p:p + 1], t["Z"][p:p + 1], t["Z_tail"][p:p + 1]
    ta, active, A = t["tail_active"][p:p + 1], t["active"], t["A"]
    n_sat = torch.tensor(int(case["n_sat"][p]), dtype=torch.int32)
    tail_g = parallel.all_reduce_sum(ta[0])
    Zp, act_new, n_drop = thy.promote_tail(Z, Zt, tail_g, active)
    s = thy.local_stats(X_p, Zp)
    staged = parallel.all_reduce_sum(s["ZtZ"], s["ZtX"], s["m"])
    sse_staged = parallel.all_reduce_sum(
        thy.local_sse(X_p, Zp * act_new, A, act_new))
    fused = parallel.all_reduce_sum(
        *thy.fused_payload(X_p, active, Z, Zt, ta, n_sat))
    ZtZ, ZtX, _, _, xx, _ = fused
    return {"tail_g": tail_g.numpy(), "active": act_new.numpy(),
            "n_drop": int(n_drop),
            "staged": [v.numpy() for v in staged],
            "sse_staged": float(sse_staged),
            "fused": [v.numpy() for v in fused],
            "sse_identity": float(thy.sse_identity(xx[0], ZtZ, ZtX, A,
                                                   act_new))}


def trace(N: int, data_seed: int, spec_kw: dict, burn: int, T: int
          ) -> tuple[np.ndarray, np.ndarray]:
    """Post-burn K+ and sigma_x traces of one shardmap chain (this rank's
    chain, with ``spec_kw`` chains="mesh")."""
    X, _, _ = cambridge_data(N=N, sigma_n=0.5, seed=data_seed)
    s = build_sampler(SamplerSpec(data="shardmap", **spec_kw), IBPHypers(),
                      X, device="cpu")
    gs, st = s.init()
    K, S = [], []
    for i in range(burn + T):
        gs, st = s.step(gs, st)
        if i >= burn:
            K.append(float(gs.active.sum()))
            S.append(float(gs.sigma_x))
    return np.array(K), np.array(S)


def drive(N: int, data_seed: int, cfg_kw: dict, eval_N: int = 0) -> dict:
    """``MCMCDriver`` under driver="shardmap" (or ``cfg_kw``'s driver),
    with ``eval_N`` held-out rows of seed ``data_seed + 1`` (none at 0);
    its result on this rank."""
    from repro_torch.runtime import DriverConfig, MCMCDriver

    X, _, _ = cambridge_data(N=N, seed=data_seed)
    X_eval = cambridge_data(N=eval_N, seed=data_seed + 1)[0] if eval_N \
        else None
    drv = MCMCDriver(X, DriverConfig(**{"driver": "shardmap", **cfg_kw}),
                     IBPHypers(), X_eval=X_eval, device="cpu")
    gs, ss = drv.run()
    return {"gs": gs_arrays(gs), "Z_shape": tuple(ss.Z.shape),
            "Z": ss.Z.numpy(), "history": drv.history,
            "bank_S": 0 if drv.bank is None else drv.bank.S}


def cli(argv: list[str]) -> dict:
    """The CLI in a rank of the group."""
    from repro_torch.launch import mcmc

    drv = mcmc.main(argv)
    return {"history": drv.history, "spec": (drv.spec.data, drv.spec.sync),
            "backend": parallel.world().backend}


def build(spec_kw: dict) -> None:
    """build_sampler in a group whose size is not P (raises)."""
    X, _, _ = cambridge_data(N=32, seed=0)
    build_sampler(SamplerSpec(data="shardmap", **spec_kw), IBPHypers(), X,
                  device="cpu")
