"""The composed chains x data mesh (chains="mesh") and the row-sharded
scorer on gloo ranks of the CPU, against the single-process layouts and
the reference.

Counterparts of tests/test_sampler_api.py's mesh tests (the port's ranks
are processes started by ``parallel.spawn``, one thread each):

* mesh C x 1 is the multichain layout (chains="vmap"), and 1 x P the
  chainless data-parallel layout, bitwise: Z, the tails and every field
  of the HybridGlobal after 5 steps and a stale pass (an all-reduce
  over a data group of one rank adds nothing; 1 x P runs the chainless
  layout's code on the same group);
* chains="mesh" x data="vmap" (a chain a rank, its shards simulated) is
  the multichain layout, bitwise (the single-chain iteration on chain
  c, which the chain-batched one computes chain by chain);
* mesh 2 x 2 under each sync: every rank of a chain holds the chain's
  HybridGlobal bitwise after each step, no collective crosses the chain
  axis in a step or a stale pass, the data axis carries 3 all-reduces
  an iteration (staged) or 1 (fused), the stale pass none, and the run
  is the multichain layout's at P=2 (Z bitwise);
* the driver: eval records with the chain-axis diagnostics, checkpoints
  crossing with the multichain layout at another P and back, a harvest
  of one sample a chain, a changed chain count refused; the CLI;
* statistics: the stationary K+ and sigma_x of mesh chains against the
  reference's chains (in tests/test_torch_shardmap.py, beside the
  shardmap chains' test, whose reference traces it shares);
* ``make_sharded_scorer`` on 1, 2 and 4 ranks: the blocks of
  ``predictive_loglik`` with ``fold_in(key, i)``, bitwise.

Every spawn has a time limit (``LIMIT_S``); a rank's failure fails the
test.
"""
import json
import shutil

import _torch_mesh_ranks as ranks
import _torch_shardmap_ranks as shardmap_ranks
import numpy as np
import pytest
import torch
from _torch_cases import bank_samples

from repro.data import cambridge_data
from repro_torch import parallel, prng
from repro_torch.core.ibp import (
    BankBuilder,
    IBPHypers,
    SampleBank,
    SamplerSpec,
    build_sampler,
    predict,
)
from repro_torch.runtime import DriverConfig, MCMCDriver

torch.set_num_threads(1)

LIMIT_S = 300.0
# the tests' small mesh: Cambridge N=48, K_max=12, K_tail=6, L=2
KW = dict(K_max=12, K_tail=6, K_init=3, L=2)
INTS = ("key", "p_prime", "it", "overflow", "tail_sat", "active")


def spawn(fn, n, *args):
    return parallel.spawn(fn, n, *args, device="cpu", timeout_s=LIMIT_S)


def multichain(P, C, key, iters):
    """The multichain layout in this process: the canonical state after
    ``iters`` steps and after a stale pass more."""
    X, _, _ = cambridge_data(N=48, sigma_n=0.4, seed=3)
    s = build_sampler(SamplerSpec(chains="vmap", n_chains=C, P=P, **KW),
                      IBPHypers(), X, device="cpu")
    gs, ss = s.init(prng.key(key))
    for _ in range(iters):
        gs, ss = s.step(gs, ss)
    out = {"step": (ss, shardmap_ranks.gs_arrays(gs))}
    gs, ss = s.stale(gs, ss)
    out["stale"] = (ss, shardmap_ranks.gs_arrays(gs))
    return out


def assert_state(got: dict, ss, gs: dict, rtol: float, tag: str,
                 atol: float = 0.0):
    """A rank's canonical state against another layout's: Z, the tails,
    the integer and bit fields bitwise, the floats within ``rtol`` (and
    ``atol``)."""
    for f in ("Z", "Z_tail", "tail_active"):
        np.testing.assert_array_equal(got[f], getattr(ss, f).numpy(),
                                      err_msg=f"{tag} {f}")
    for f, want in gs.items():
        if f in INTS:
            np.testing.assert_array_equal(got["gs"][f], want,
                                          err_msg=f"{tag} {f}")
        else:
            np.testing.assert_allclose(got["gs"][f], want, rtol=rtol,
                                       atol=atol, err_msg=f"{tag} {f}")


NONE = dict.fromkeys(parallel.group.OPS, 0)


@pytest.mark.parametrize("data,P,C", [("shardmap", 1, 2), ("vmap", 3, 2)],
                         ids=["Cx1", "chains-mesh-x-data-vmap"])
def test_mesh_matches_multichain_bitwise(data, P, C):
    """mesh C x 1 (data="shardmap" on C ranks) and chains="mesh" x
    data="vmap" (C ranks, P shards each) advance the multichain layout's
    trajectories: every rank's canonical state equals it after 5 steps
    and after a stale pass, and no step or stale pass made a collective
    across the chain axis."""
    res = spawn(ranks.mesh_run, C, 48, 3, dict(KW, P=P, data=data,
                                                n_chains=C), 7, 5)
    want = multichain(P, C, 7, 5)
    for r in res:
        for which in ("step", "stale"):
            assert_state(r[which], *want[which], 0.0,
                         f"rank {r['coords']} {which}")
        for st in r["steps"]:
            assert st["counts"]["chains"] == NONE
        assert r["stale_counts"][None] == NONE


def test_mesh_1xP_matches_shardmap_bitwise():
    """mesh with 1 chain x P data shards computes the chainless shardmap
    layout's steps and stale pass from the same canonical state (the
    init differs by design: a chained layout splits the key)."""
    res = spawn(ranks.against_shardmap, 4, 48, 3, dict(KW, P=4), 9, 5)
    for r in res:
        for which in ("", "_stale"):
            got, want = r["mesh" + which], r["shardmap" + which]
            for f in ("Z", "Z_tail", "tail_active"):
                np.testing.assert_array_equal(got[f][0], want[f])
            for f, v in want["gs"].items():
                np.testing.assert_array_equal(got["gs"][f][0], v,
                                              err_msg=f)


@pytest.mark.parametrize("sync,all_reduces", [("staged", 3), ("fused", 1)])
def test_mesh_2x2_replicates_each_chain_and_never_crosses_chains(
        sync, all_reduces):
    res = spawn(ranks.mesh_run, 4, 48, 3, dict(KW, P=2, data="shardmap",
                                                n_chains=2, sync=sync), 5, 3)
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        for i, st in enumerate(r["steps"]):
            assert st["counts"]["chains"] == NONE, (r["coords"], i)
            assert st["counts"]["data"] == dict(
                NONE, all_reduce_sum=all_reduces)
            assert st["counts"][None] == st["counts"]["data"]
            # the rank of the other shard of this chain holds its bits
            peer = res[2 * r["coords"][0] + 1 - r["coords"][1]]
            for f, v in st["gs"].items():
                np.testing.assert_array_equal(
                    v, peer["steps"][i]["gs"][f],
                    err_msg=f"{r['coords']} step {i} {f}")
        assert r["stale_counts"][None] == NONE
    # the chains are independent: chain 0 and 1 differ
    assert not np.array_equal(res[0]["step"]["Z"][0], res[0]["step"]["Z"][1])
    # the run is the multichain layout's: Z bitwise, the floats up to the
    # all-reduce's order of summation (A as tests/test_torch_shardmap.py)
    want = multichain(2, 2, 5, 3)
    for which in ("step", "stale"):
        assert_state(res[0][which], *want[which], 1e-5, which, atol=1e-5)


def test_mesh_driver_runs_and_interchanges_checkpoints(tmp_path):
    """driver='mesh' (2 chains x 2 data shards on 4 ranks) runs end to end
    through MCMCDriver with a stale pass and a harvest, reports the
    chain-axis diagnostics in its eval records, and its checkpoints
    restore under driver='multichain' at P=4 and back; a changed chain
    count is refused."""
    X, _, _ = cambridge_data(N=48, seed=3)
    kw = dict(P=2, K_max=12, K_tail=6, L=2, n_iters=16, ckpt_every=8,
              eval_every=16, driver="mesh", n_chains=2, stale_sync=1,
              harvest_every=4, ckpt_dir=str(tmp_path))
    res = spawn(shardmap_ranks.drive, 4, 48, 3, kw)
    for r in res[1:]:
        for f, v in res[0]["gs"].items():
            np.testing.assert_array_equal(r["gs"][f], v, err_msg=f)
        for got, want in zip(r["history"], res[0]["history"]):
            np.testing.assert_equal(  # all but each rank's own clock
                {k: v for k, v in got.items() if k != "t"},
                {k: v for k, v in want.items() if k != "t"})
    r = res[0]
    assert r["Z"].shape == (2, 2, 24, 12)              # chain axis kept
    rec = r["history"][-1]
    assert len(rec["K_chains"]) == 2 and rec["it"] == 16
    assert np.isfinite(rec["sigma_x_rhat"])
    assert np.isfinite(rec["joint_ll_train"])
    assert list(r["gs"]["it"]) == [16, 16]
    # the checkpoint holds the gathered chains' Z_global (C, N, K)
    blob = np.load(tmp_path / "step_000000016.npz")
    np.testing.assert_array_equal(blob["leaf_00000"],
                                  r["Z"].reshape(2, 48, 12))
    # the harvest at iterations 12 and 16: a sample a chain, written once
    bank = SampleBank.load(str(tmp_path / "bank.npz"), "cpu")
    assert [r_["bank_S"] for r_ in res] == [4, 0, 0, 0]  # rank 0 keeps it
    assert bank.chain.tolist() == [0, 1, 0, 1]
    # the mesh checkpoint resumes under the multichain driver at P=4
    cfg_mc = DriverConfig(**dict(kw, driver="multichain", P=4, n_iters=20,
                                 harvest_every=0))
    drv = MCMCDriver(X, cfg_mc, IBPHypers(), device="cpu")
    gs2, ss2 = drv.run()
    assert gs2.it.tolist() == [20, 20] and ss2.Z.shape[:2] == (2, 4)
    # and the multichain checkpoint resumes under the mesh
    res = spawn(shardmap_ranks.drive, 4, 48, 3,
                dict(kw, n_iters=24, harvest_every=0))
    assert list(res[0]["gs"]["it"]) == [24, 24]
    assert [h["it"] for h in res[0]["history"]] == [24]
    # changing the chain count across a restart fails loudly
    with pytest.raises(ValueError, match="n_chains=3"):
        spawn(shardmap_ranks.drive, 3, 48, 3,
              dict(kw, n_chains=3, P=1, n_iters=30))


def test_mesh_eval_train_loglik_is_the_sum_over_data_ranks(tmp_path):
    """The mesh's per-chain joint_ll_train, each a sum over the chain's
    data ranks, its held-out joint_ll_eval, each rank's own chain's
    gathered, and its per-chain lists equal the multichain driver's
    one-device values: both resume one multichain checkpoint for the
    same step."""
    X, _, _ = cambridge_data(N=48, seed=3)
    X_eval = cambridge_data(N=16, seed=4)[0]
    kw = dict(P=2, K_max=12, K_tail=6, L=2, n_iters=4, ckpt_every=4,
              eval_every=1, n_chains=2, ckpt_dir=str(tmp_path / "m"))
    MCMCDriver(X, DriverConfig(driver="multichain", **kw),
               device="cpu").run()
    shutil.copytree(tmp_path / "m", tmp_path / "s")
    res = spawn(shardmap_ranks.drive, 4, 48, 3,
                dict(kw, driver="mesh", n_iters=5,
                     ckpt_dir=str(tmp_path / "s")), 16)
    drv = MCMCDriver(X, DriverConfig(driver="multichain",
                                     **dict(kw, n_iters=5)),
                     X_eval=X_eval, device="cpu")
    _, ss = drv.run()
    np.testing.assert_array_equal(res[0]["Z"], ss.Z.numpy())
    got, want = res[0]["history"][-1], drv.history[-1]
    assert got["it"] == want["it"] == 5
    assert got["K_chains"] == want["K_chains"]
    np.testing.assert_allclose(got["joint_ll_train_chains"],
                               want["joint_ll_train_chains"], rtol=1e-5)
    np.testing.assert_allclose(got["sigma_x_chains"], want["sigma_x_chains"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["joint_ll_eval"], want["joint_ll_eval"],
                               rtol=1e-5)


def test_cli_runs_mesh_on_ranks(tmp_path):
    out = tmp_path / "h.json"
    argv = ["--device", "cpu", "--driver", "mesh", "--P", "2", "--N", "60",
            "--iters", "4", "--eval-every", "2", "--K-max", "8", "--L", "2",
            "--ckpt-dir", str(tmp_path / "ck"), "--out", str(out)]
    res = spawn(shardmap_ranks.cli, 4, argv)
    assert {r["spec"] for r in res} == {("shardmap", "staged")}
    hist = json.loads(out.read_text())     # rank 0 wrote it
    assert [r["it"] for r in hist] == [2, 4]
    for r in hist:
        assert len(r["K_chains"]) == 2 and np.isfinite(r["joint_ll_eval"])
    for r in res:
        assert [h["K_chains"] for h in r["history"]] == \
            [h["K_chains"] for h in hist]


BANK = dict(K_max=16, lives=(5, 9, 7), D=12, seed=15)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_scorer_is_the_blocks_of_predictive_loglik(n):
    """Rank i scores rows [i·B/n, (i+1)·B/n) under fold_in(key, i); every
    rank returns the whole batch, bitwise the one-process blocks; at one
    rank it is predictive_loglik under fold_in(key, 0) (the reference's
    tests/test_predict.py::test_sharded_scorer_matches_unsharded); a
    batch the ranks do not divide is refused."""
    X = np.random.default_rng(16).normal(size=(8, 12)).astype(np.float32)
    res = spawn(ranks.sharded_score, n, BANK, X, 7, 3, 7)
    b = BankBuilder(BANK["K_max"])
    for kw in bank_samples(**BANK):
        b.add(**kw)
    bank, key = b.build("cpu"), prng.key(7)
    want = np.concatenate([predict.predictive_loglik(
        bank, X[i * 8 // n:(i + 1) * 8 // n], prng.fold_in(key, i),
        n_sweeps=3).numpy() for i in range(n)])
    for r in res:
        np.testing.assert_array_equal(r["scores"], want)
        assert r["scores"].shape == (8,) and np.all(np.isfinite(r["scores"]))
        if n > 1:
            assert f"B=7 rows do not split over the {n} ranks" in r["bad"]
    if n == 1:
        one = predict.predictive_loglik(bank, X, prng.fold_in(key, 0),
                                        n_sweeps=3).numpy()
        np.testing.assert_allclose(res[0]["scores"], one, rtol=1e-6,
                                   atol=1e-6)
