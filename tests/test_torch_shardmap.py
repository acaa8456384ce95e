"""The data-parallel layout (data="shardmap") on P gloo ranks of the CPU,
against the vmap layout and the reference.

Counterparts of tests/test_distributed.py's shardmap tests (the port's
ranks are processes started by ``parallel.spawn``, one thread each),
plus:

* the syncs against the reference on one seeded case: the fused
  payload reduced over ranks, the staged schedule's statistics and its
  SSE, and the SSE identity, against the reference's ``promote_tail`` +
  ``local_stats`` summed over shards and its ``local_sse``;
* replication and collective counts: after every step every rank holds
  the same HybridGlobal bits; staged makes 3 all-reduces an iteration,
  fused 1 (and no SSE reduction), a stale pass 0;
* statistics: the stationary K+ and sigma_x of shardmap chains, and of
  the chains of a 2 x 2 chains="mesh", against
  the reference's chains, |z| < 4 with the MCSE-aware z of
  ``convergence.mean_diff_z``.

Every spawn has a time limit (``LIMIT_S``); a rank's failure fails the
test.
"""
import shutil

import _torch_shardmap_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ibp import IBPHypers as JHypers
from repro.core.ibp import SamplerSpec as JSpec
from repro.core.ibp import build_sampler as jax_build_sampler
from repro.core.ibp import hybrid as jhy
from repro.data import cambridge_data
from repro_torch import parallel
from repro_torch.core.ibp import convergence
from repro_torch.runtime import DriverConfig, MCMCDriver

torch.set_num_threads(1)

LIMIT_S = 300.0


def spawn(fn, P, *args):
    return parallel.spawn(fn, P, *args, device="cpu", timeout_s=LIMIT_S)


def assert_replicated(results, key="steps"):
    """Every rank's HybridGlobal equals rank 0's bitwise after each step."""
    for r, res in enumerate(results[1:], 1):
        for i, (want, got) in enumerate(zip(results[0][key], res[key])):
            for f in want:
                np.testing.assert_array_equal(
                    got[f], want[f], err_msg=f"rank {r} step {i} {f}")


def test_shardmap_hybrid_runs_and_converges():
    res = spawn(ranks.converge, 8, 96, 1,
                dict(P=8, K_max=16, K_tail=6, K_init=4, L=5), 1, 40)
    assert_replicated(res)
    gs = res[0]["steps"][-1]
    K, sx = int(gs["active"].sum()), float(gs["sigma_x"])
    assert 3 <= K <= 9, K
    assert 0.3 <= sx <= 0.75, sx
    assert res[0]["Z"].shape == (8, 12, 16)


def test_shardmap_matches_vmap_semantics():
    """The shardmap and vmap layouts from one canonical state and key give
    the same states: Z bitwise, the float scalars up to reduction-order
    ULPs (all-reduce vs one-device sum)."""
    res = spawn(ranks.against_vmap, 4, 32, 4,
                dict(P=4, K_max=12, K_tail=4, K_init=3, L=2), 2, 5)
    assert_replicated(res)
    r = res[0]
    gv, gs = r["vmap"], r["steps"][-1]
    np.testing.assert_array_equal(r["Z"], r["vmap_Z"])
    np.testing.assert_allclose(gs["sigma_x"], gv["sigma_x"], rtol=1e-5)
    np.testing.assert_allclose(gs["sigma_a"], gv["sigma_a"], rtol=1e-5)
    np.testing.assert_allclose(gs["A"], gv["A"], atol=1e-5)
    assert int(gs["p_prime"]) == int(gv["p_prime"])
    assert int(gs["it"]) == 5


@pytest.mark.parametrize("sync,all_reduces,sse_calls", [
    ("staged", 3, 1), ("fused", 1, 0)])
def test_sync_collectives_and_replication(sync, all_reduces, sse_calls):
    res = spawn(ranks.against_vmap, 4, 32, 4,
                dict(P=4, K_max=12, K_tail=4, K_init=3, L=2, sync=sync), 6, 4)
    assert_replicated(res)
    for r in res:
        assert r["all_reduces"] == [all_reduces] * 4
        assert r["sse_calls"] == [sse_calls] * 4


def test_stale_pass_makes_no_collective_and_is_the_vmap_pass():
    res = spawn(ranks.stale_pass, 4, 32,
                dict(P=4, K_max=12, K_tail=4, K_init=3, L=2), 3)
    for r in res:
        assert r["counts"] == dict.fromkeys(parallel.group.OPS, 0)
        for f in r["gs"]:
            np.testing.assert_array_equal(r["gs"][f], r["gs_vmap"][f],
                                          err_msg=f)
        for got, want in zip(r["shard"], r["vmap"]):
            np.testing.assert_array_equal(got, want)


def test_fused_sync_matches_staged():
    """The fused single all-reduce (SSE by the trace identity, the tail
    mask in the payload) computes the staged iteration, up to
    reduction-order ULPs."""
    outs = {}
    for sync in ("staged", "fused"):
        res = spawn(ranks.converge, 4, 64, 9,
                    dict(P=4, K_max=12, K_tail=4, K_init=3, L=2, sync=sync),
                    3, 3)
        assert_replicated(res)
        gs = res[0]["steps"][-1]
        outs[sync] = (res[0]["Z"], gs["A"], float(gs["sigma_x"]),
                      gs["active"])
    np.testing.assert_array_equal(outs["staged"][0], outs["fused"][0])
    np.testing.assert_allclose(outs["staged"][1], outs["fused"][1],
                               atol=1e-4)
    np.testing.assert_allclose(outs["staged"][2], outs["fused"][2],
                               rtol=1e-4)
    np.testing.assert_array_equal(outs["staged"][3], outs["fused"][3])


def _sync_case(P=4, N_p=16, D=12, K=10, K_tail=4, p_prime=2, seed=0):
    """Seeded inputs of a sync: 6 of K slots live, p′'s tail with 3 live
    columns (the rest of the shards' tails zero)."""
    rng = np.random.default_rng(seed)
    active = np.zeros(K, np.float32)
    active[[0, 1, 3, 4, 6, 8]] = 1.0
    Z = (rng.random((P, N_p, K)) < 0.4).astype(np.float32) * active
    ta = np.zeros((P, K_tail), np.float32)
    ta[p_prime] = [1.0, 1.0, 0.0, 1.0]
    Zt = (rng.random((P, N_p, K_tail)) < 0.3).astype(np.float32) * ta[:, None]
    A = (rng.standard_normal((K, D)) * active[:, None]).astype(np.float32)
    X = (np.einsum("pnk,kd->pnd", Z, A)
         + 0.3 * rng.standard_normal((P, N_p, D))).astype(np.float32)
    n_sat = np.zeros(P, np.int32)
    n_sat[p_prime] = 2
    return dict(X=X, Z=Z, Z_tail=Zt, tail_active=ta, active=active, A=A,
                n_sat=n_sat)


def test_syncs_reduce_what_the_reference_sums():
    """Tolerances: m, ZᵀZ and the tail mask are integer sums (exact);
    ZᵀX, ΣX² and the SSEs are float32 sums in another order (rtol 1e-5);
    the SSE identity cancels tr(XᵀX) against the fit (rtol 1e-4)."""
    case = _sync_case()
    res = spawn(ranks.sync_parts, 4, case)
    for r in res[1:]:
        for k in ("tail_g", "active", "sse_staged", "sse_identity"):
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)
    r = res[0]
    j = {k: jnp.asarray(v) for k, v in case.items()}
    tail_g = jnp.sum(j["tail_active"], axis=0)
    stats, sse = [], 0.0
    for p in range(4):
        Zp, act, n_drop = jhy.promote_tail(j["Z"][p], j["Z_tail"][p], tail_g,
                                           j["active"])
        stats.append(jhy.local_stats(j["X"][p], Zp))
        sse += float(jhy.local_sse(j["X"][p], Zp * act[None, :], j["A"], act))
    want = {k: np.sum([np.asarray(s[k]) for s in stats], axis=0)
            for k in ("ZtZ", "ZtX", "m")}
    np.testing.assert_array_equal(r["tail_g"], np.asarray(tail_g))
    np.testing.assert_array_equal(r["active"], np.asarray(act))
    assert r["n_drop"] == int(n_drop) == 0
    for got, k in zip(r["staged"], ("ZtZ", "ZtX", "m")):
        np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(r["staged"][0], want["ZtZ"])
    np.testing.assert_array_equal(r["staged"][2], want["m"])
    ZtZ, ZtX, m, ta, xx, n_sat = r["fused"]
    np.testing.assert_array_equal(ZtZ, want["ZtZ"])
    np.testing.assert_allclose(ZtX, want["ZtX"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(m, want["m"])
    np.testing.assert_array_equal(ta, np.asarray(tail_g))
    np.testing.assert_allclose(xx[0], float(np.sum(case["X"] ** 2)),
                               rtol=1e-5)
    assert n_sat[0] == 2.0
    np.testing.assert_allclose(r["sse_staged"], sse, rtol=1e-5)
    np.testing.assert_allclose(r["sse_identity"], sse, rtol=1e-4)


def test_build_refuses_a_group_of_another_size():
    with pytest.raises(ValueError, match=r"P=4 needs a torch.distributed "
                       r"group of 4 ranks.*is in a group of 2 ranks"):
        spawn(ranks.build, 2, dict(P=4))


def test_driver_shardmap_backend_selectable(tmp_path):
    """MCMCDriver with driver='shardmap' end to end (stale pass,
    checkpoints, diagnostics) on 8 ranks; its checkpoint resumes under
    vmap at P=4, and a vmap checkpoint resumes under shardmap."""
    X, _, _ = cambridge_data(N=96, seed=5)
    kw = dict(P=8, K_max=16, K_tail=6, L=3, n_iters=20, ckpt_every=10,
              eval_every=10, stale_sync=1, ckpt_dir=str(tmp_path))
    res = spawn(ranks.drive, 8, 96, 5, kw)
    for r in res[1:]:
        for f in r["gs"]:
            np.testing.assert_array_equal(r["gs"][f], res[0]["gs"][f])
        for got, want in zip(r["history"], res[0]["history"]):
            np.testing.assert_equal(  # all but each rank's own clock
                {k: v for k, v in got.items() if k != "t"},
                {k: v for k, v in want.items() if k != "t"})
    gs = res[0]["gs"]
    K, sx = int(gs["active"].sum()), float(gs["sigma_x"])
    assert 2 <= K <= 10, K
    assert 0.3 <= sx <= 0.8, sx
    assert res[0]["Z_shape"] == (8, 12, 16)
    rec = res[0]["history"][-1]
    assert "sigma_x_rhat" in rec and np.isfinite(rec["joint_ll_train"])
    # the checkpoint holds Z_global (N, K), gathered from the ranks
    blob = np.load(tmp_path / "step_000000020.npz")
    np.testing.assert_array_equal(blob["leaf_00000"],
                                  res[0]["Z"].reshape(96, 16))
    # the same checkpoint resumes under vmap, at another P
    cfg_v = DriverConfig(**dict(kw, P=4, n_iters=25))
    gs2, ss2 = MCMCDriver(X, cfg_v, device="cpu").run()
    assert int(gs2.it) == 25 and ss2.Z.shape[0] == 4
    # and the vmap checkpoint resumes under shardmap
    res = spawn(ranks.drive, 8, 96, 5, dict(kw, n_iters=27))
    assert int(res[0]["gs"]["it"]) == 27
    assert [r["it"] for r in res[0]["history"]] == [27]


def test_eval_train_loglik_is_the_sum_over_ranks(tmp_path):
    """The eval record's joint_ll_train under shardmap, a sum over ranks
    of each rank's part, equals the vmap layout's one-device value: both
    resume one vmap checkpoint for the same step."""
    X, _, _ = cambridge_data(N=64, seed=2)
    kw = dict(P=4, K_max=12, K_tail=4, L=2, n_iters=4, ckpt_every=4,
              eval_every=1, ckpt_dir=str(tmp_path / "v"))
    MCMCDriver(X, DriverConfig(**kw), device="cpu").run()
    shutil.copytree(tmp_path / "v", tmp_path / "s")
    res = spawn(ranks.drive, 4, 64, 2,
                dict(kw, n_iters=5, ckpt_dir=str(tmp_path / "s")))
    drv = MCMCDriver(X, DriverConfig(**dict(kw, n_iters=5)), device="cpu")
    _, ss = drv.run()
    np.testing.assert_array_equal(res[0]["Z"], ss.Z.numpy())
    got, want = res[0]["history"][-1], drv.history[-1]
    assert got["it"] == want["it"] == 5 and got["K"] == want["K"]
    np.testing.assert_allclose(got["joint_ll_train"], want["joint_ll_train"],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def reference_traces():
    X, _, _ = cambridge_data(N=100, sigma_n=0.5, seed=1)
    js = jax_build_sampler(JSpec(P=4, K_max=16, L=2), JHypers(), X)
    gs, st = js.init(jax.random.key(0))
    K, S = [], []
    for i in range(50 + 250):
        gs, st = js.step(gs, st)
        if i >= 50:
            K.append(float(gs.active.sum()))
            S.append(float(gs.sigma_x))
    return np.array(K), np.array(S)


@pytest.mark.parametrize("sync", ["staged", "fused"])
def test_shardmap_matches_reference_statistically(sync, reference_traces):
    K_t, S_t = spawn(ranks.trace, 4, 100, 1,
                     dict(P=4, K_max=16, L=2, sync=sync), 50, 250)[0]
    K_j, S_j = reference_traces
    assert np.all((K_t >= 1) & (K_t <= 16)) and np.all(np.isfinite(S_t))
    for name, a, b in (("K+", K_t, K_j), ("sigma_x", S_t, S_j)):
        z = convergence.mean_diff_z(a, b)
        assert abs(z) < 4.0, (name, a.mean(), b.mean(), z)


def test_mesh_matches_reference_statistically(reference_traces):
    """2 chains x 2 shards (chains="mesh", fused): the chains' pooled
    stationary K+ and sigma_x against the reference's, |z| < 4."""
    res = spawn(ranks.trace, 4, 100, 1,
                dict(P=2, K_max=16, L=2, chains="mesh", n_chains=2,
                     sync="fused"), 50, 150)
    np.testing.assert_array_equal(res[1][0], res[0][0])  # replicated
    K_t = np.stack([res[0][0], res[2][0]])          # chains 0 and 1
    S_t = np.stack([res[0][1], res[2][1]])
    K_j, S_j = reference_traces
    assert np.all((K_t >= 1) & (K_t <= 16)) and np.all(np.isfinite(S_t))
    for name, a, b in (("K+", K_t, K_j), ("sigma_x", S_t, S_j)):
        z = convergence.mean_diff_z(a, b)
        assert abs(z) < 4.0, (name, a.mean(), b.mean(), z)
