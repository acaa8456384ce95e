"""C independent chains on one device (``chains="vmap"``, the multichain
driver) and the bounded-staleness pass, against the single-chain port
and the reference.

* Chains are independent: ``init_multichain``'s chain c is
  ``init_hybrid`` from split key c, bitwise; one chain-batched iteration
  or stale pass gives, for every chain, what the single-chain function
  gives on that chain's state (Z bits, counters, keys and p′ equal,
  floats within 1e-6 relative: the same float32 operations on the same
  values), also where the chains' p′ differ, so each tail is gathered
  from and scattered to its own shard.
* The chained plain scan is C single plain scans, bitwise; the chained
  form takes MH births on the full width only.
* Whole chains, statistically: the reference's and the port's
  ``SamplerSpec(chains="vmap", n_chains=4)`` on the same data, K+ and
  σ_x pooled over chains, |z| < 4 by ``convergence.mean_diff_z`` (the
  tolerance of tests/test_exactness.py).
* The driver: the reference's multichain tests (tests/test_driver.py)
  on the port; checkpoints cross between the packages with the chain
  axis; grow and shrink restores per chain; a harvest adds C samples;
  the CLI's --driver multichain --chains --stale-sync.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from _torch_cases import scan_case

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.core.ibp import IBPHypers as JHypers
from repro.core.ibp import SamplerSpec as JSpec
from repro.core.ibp import build_sampler as jax_build_sampler
from repro.core.ibp import hybrid as jhy
from repro.data import cambridge_data
from repro.runtime import DriverConfig as JConfig
from repro.runtime import MCMCDriver as JDriver
from repro_torch import prng
from repro_torch.checkpoint import save_pytree
from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
from repro_torch.core.ibp import convergence
from repro_torch.core.ibp import hybrid as thy
from repro_torch.interop import from_reference
from repro_torch.kernels.collapsed_scan import collapsed_scan, collapsed_scan_ref
from repro_torch.launch import mcmc
from repro_torch.runtime import DriverConfig, MCMCDriver

torch.set_num_threads(1)

C = 3


@pytest.fixture(scope="module")
def X():
    return cambridge_data(N=48, sigma_n=0.4, seed=3)[0]


def _Xs(X, P):
    N = (X.shape[0] // P) * P
    return torch.from_numpy(X[:N].reshape(P, N // P, -1))


def _assert_chain_equal(got, want, tag):
    """Two states field for field: integer and bit fields equal, floats
    within 1e-6 relative."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape and a.dtype == b.dtype, (tag, f.name)
        if f.name in ("Z", "Z_tail", "tail_active", "active") \
                or not a.dtype.is_floating_point:
            assert torch.equal(a, b), (tag, f.name)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0,
                                       msg=f"{tag} {f.name}")


def test_init_multichain_is_init_hybrid_per_split_key(X):
    Xs = _Xs(X, 3)
    key = prng.key(11)
    gs, ss = thy.init_multichain(key, Xs, C, 12, K_tail=4, K_init=3)
    assert gs.key.shape == (C, 2) and gs.p_prime.shape == (C,)
    assert ss.Z.shape == (C, 3, 16, 12) and ss.tail_active.shape == (C, 3, 4)
    for c, k in enumerate(prng.split(key, C)):
        g1, s1 = thy.init_hybrid(k, Xs, 12, K_tail=4, K_init=3)
        for t, t1 in ((gs, g1), (ss, s1)):
            for f in dataclasses.fields(t1):
                assert torch.equal(getattr(t, f.name)[c],
                                   getattr(t1, f.name)), (c, f.name)
    # the chains start apart: independent Z draws
    assert not torch.equal(ss.Z[0], ss.Z[1])


def test_prng_stack_derives_each_chain_as_its_own_key():
    keys = torch.stack(prng.split(prng.key(5), 4))
    for tag in (0, 13, 0xFFFFFFFF):
        got = prng.fold_in(keys, tag)
        assert got.shape == (4, 2) and got.dtype == torch.uint32
        for c in range(4):
            assert torch.equal(got[c], prng.fold_in(keys[c], tag))
    for i, k in enumerate(prng.split(keys, 3)):
        for c in range(4):
            assert torch.equal(k[c], prng.split(keys[c], 3)[i])


# "ref" is the O(K^3) row-step oracle (chain by chain), "fast" and
# "pallas" the carried scan (one chained scan of the C tails)
@pytest.mark.parametrize("backend", ["fast", "pallas", "ref"])
@pytest.mark.parametrize("which", ["step", "stale"])
def test_chained_iteration_is_the_single_chain_iteration_per_chain(
        X, backend, which):
    s = build_sampler(SamplerSpec(P=3, K_max=12, K_tail=4, K_init=3, L=2,
                                  chains="vmap", n_chains=C,
                                  collapsed_backend=backend),
                      IBPHypers(), X, device="cpu")
    gs, ss = s.init(prng.key(2))
    # a different p' for every chain, and a live tail on each chain's p'
    # (a stale pass carries it on; the next step promotes it)
    gs = dataclasses.replace(gs, p_prime=torch.tensor([0, 2, 1],
                                                      dtype=torch.int32))
    gs, ss = s.stale(gs, ss)
    assert [int(ss.tail_active[c].sum(-1).argmax()) for c in range(C)
            if ss.tail_active[c].sum() > 0] == \
        [p for c, p in enumerate([0, 2, 1]) if ss.tail_active[c].sum() > 0]
    one = build_sampler(s.spec.replace(chains="none", n_chains=1),
                        IBPHypers(), X, device="cpu")
    fn = s.step if which == "step" else s.stale
    fn1 = one.step if which == "step" else one.stale
    gs2, ss2 = fn(gs, ss)
    for c in range(C):
        g1, s1 = fn1(thy.chain_of(gs, c), thy.chain_of(ss, c))
        _assert_chain_equal(thy.chain_of(gs2, c), g1, f"{which} chain {c}")
        _assert_chain_equal(thy.chain_of(ss2, c), s1, f"{which} chain {c}")
    assert not torch.equal(ss2.Z[0], ss2.Z[1])


def test_chained_plain_scan_is_single_plain_scans():
    cases = [scan_case(40, 8, 12, seed=s, lam=0.2) for s in (1, 2, 3)]
    fields = ("Z", "active", "ZtZ", "ZtX", "m", "X", "u_logit", "j_prop",
              "log_u_acc")
    sx = torch.tensor([0.5, 0.6, 0.45])
    sa = torch.tensor([1.0, 0.9, 1.2])
    kw = dict(N=160.0, refresh_every=8, drift_tol=1e-2, flavor="fast")
    st = {f: torch.from_numpy(np.stack([c[f] for c in cases])) for f in fields}
    counts = collapsed_scan(*(st[f] for f in fields), sx, sa, **kw)
    assert counts.shape == (3, 3)
    for i, case in enumerate(cases):
        one = {f: torch.from_numpy(case[f].copy()) for f in fields}
        ci = collapsed_scan_ref(*(one[f] for f in fields), sx[i], sa[i], **kw)
        assert torch.equal(counts[i], ci), i
        for f in ("Z", "active", "ZtZ", "ZtX", "m"):
            assert torch.equal(st[f][i], one[f]), (i, f)
    assert counts[:, 0].sum() > 0  # refreshes ran
    # the chained form is the hybrid tail's: MH births, full width, row 0
    for bad in (dict(B=4), dict(start_row=3)):
        with pytest.raises(ValueError, match="chained scan"):
            collapsed_scan(*(st[f] for f in fields), sx, sa, **kw, **bad)
    with pytest.raises(ValueError, match="chained scan"):
        collapsed_scan(*(st[f] for f in fields), sx, sa, **kw,
                       gumbel=torch.zeros(3, 40, 5), alpha=torch.ones(3))


def test_from_reference_carries_a_multichain_state(X):
    Xs = _Xs(X, 2).numpy()
    gs, ss = jhy.init_multichain(jax.random.key(4), jax.numpy.asarray(Xs),
                                 C, 12, K_tail=4)
    gs_np = {f: np.asarray(jax.random.key_data(v) if f == "key" else v)
             for f, v in vars(gs).items()}
    ss_np = {f: np.asarray(v) for f, v in vars(ss).items()}
    assert gs_np["key"].shape == (C, 2)
    tgs, tss = from_reference(gs_np, ss_np, device="cpu")
    for t, ref in ((tgs, gs_np), (tss, ss_np)):
        for f, v in ref.items():
            np.testing.assert_array_equal(getattr(t, f).numpy(), v,
                                          err_msg=f)
    assert tgs.key.dtype == torch.uint32
    # and the port steps it as a chain-batched state
    s = build_sampler(SamplerSpec(P=2, K_max=12, K_tail=4, L=1,
                                  chains="vmap", n_chains=C),
                      IBPHypers(), X, device="cpu")
    g2, s2 = s.step(tgs, tss)
    assert g2.it.tolist() == [1] * C and s2.Z.shape == tss.Z.shape


def _traces(step, gs, st, burn, T):
    K, S = [], []
    for i in range(burn + T):
        gs, st = step(gs, st)
        if i >= burn:
            K.append(np.asarray(gs.active).sum(-1))
            S.append(np.asarray(gs.sigma_x))
    return np.stack(K, axis=1), np.stack(S, axis=1)  # (C, T)


def test_multichain_matches_reference_statistically():
    X, _, _ = cambridge_data(N=100, sigma_n=0.5, seed=1)
    burn, T = 40, 80
    kw = dict(P=2, K_max=16, L=2, chains="vmap", n_chains=4)
    js = jax_build_sampler(JSpec(**kw), JHypers(), X)
    K_j, S_j = _traces(js.step, *js.init(jax.random.key(0)), burn, T)
    ts = build_sampler(SamplerSpec(**kw), IBPHypers(), X, device="cpu")
    K_t, S_t = _traces(ts.step, *ts.init(), burn, T)
    assert K_t.shape == (4, T)
    assert np.all((K_t >= 1) & (K_t <= 16)) and np.all(np.isfinite(S_t))
    for name, a, b in (("K+", K_t, K_j), ("sigma_x", S_t, S_j)):
        z = convergence.mean_diff_z(a, b)
        assert abs(z) < 4.0, (name, a.mean(), b.mean(), z)


@pytest.mark.parametrize("chains", ["none", "vmap"])
def test_stale_pass_hands_on_fold_14_and_consumes_fold_13(X, chains):
    s = build_sampler(SamplerSpec(P=3, K_max=12, K_tail=6, K_init=3, L=2,
                                  chains=chains,
                                  n_chains=C if chains == "vmap" else 1),
                      IBPHypers(), X, device="cpu")
    gs, st = s.init(prng.key(0))
    gs2, st2 = s.stale(gs, st)
    assert not torch.equal(gs2.key, prng.fold_in(gs.key, 13))
    assert torch.equal(gs2.key, prng.fold_in(gs.key, 14))
    # no sync: the global parameters and counters are untouched
    for f in ("A", "pi", "active", "sigma_x", "alpha", "p_prime", "it",
              "tail_sat", "overflow"):
        assert torch.equal(getattr(gs2, f), getattr(gs, f)), f
    assert not torch.equal(st2.Z, st.Z)


def _mc(tmp, sub, n, c=C, **kw):
    base = dict(P=3, K_max=12, K_tail=6, L=2, n_iters=n, ckpt_every=1000,
                eval_every=1000, driver="multichain", n_chains=c,
                ckpt_dir=str(tmp / sub))
    base.update(kw)
    return DriverConfig(**base)


def test_stale_sync_knob_runs_and_differs(X, tmp_path):
    gs0, _ = MCMCDriver(X, _mc(tmp_path, "a", 4), device="cpu").run()
    gs2, _ = MCMCDriver(X, _mc(tmp_path, "b", 4, stale_sync=2),
                        device="cpu").run()
    assert torch.isfinite(gs2.sigma_x).all()
    assert ((gs2.active.sum(-1) >= 1) & (gs2.active.sum(-1) <= 12)).all()
    # the stale trajectory consumed other randomness: another state
    assert not torch.equal(gs0.sigma_x, gs2.sigma_x)


def test_multichain_resumes_bitwise_from_checkpoint(X, tmp_path):
    gs_a, ss_a = MCMCDriver(X, _mc(tmp_path, "full", 6, ckpt_every=3),
                            device="cpu").run()
    MCMCDriver(X, _mc(tmp_path, "half", 3, ckpt_every=3), device="cpu").run()
    gs_b, ss_b = MCMCDriver(X, _mc(tmp_path, "half", 6, ckpt_every=3),
                            device="cpu").run()
    for f in dataclasses.fields(gs_a):
        assert torch.equal(getattr(gs_a, f.name), getattr(gs_b, f.name)), f
    assert torch.equal(ss_a.Z, ss_b.Z)
    assert gs_b.it.tolist() == [6] * C


def test_multichain_eval_records_diagnostics(X, tmp_path):
    drv = MCMCDriver(X, _mc(tmp_path, "d", 16, c=4, eval_every=8),
                     X_eval=X[:8], device="cpu")
    gs, ss = drv.run()
    assert ss.Z.shape[0] == 4
    rec = drv.history[-1]
    for k in ("sigma_x_rhat", "sigma_x_ess", "sigma_x_mcse", "K_rhat",
              "K_ess", "K_mcse"):
        assert k in rec and np.isfinite(rec[k]), (k, rec.get(k))
    for k in ("K_chains", "sigma_x_chains", "joint_ll_train_chains",
              "tail_sat_chains"):
        assert len(rec[k]) == 4, k
    assert rec["K"] == pytest.approx(np.mean(rec["K_chains"]))
    assert rec["tail_sat"] == max(rec["tail_sat_chains"])
    # each chain's held-out log-likelihood under fold_in(key_c, 999)
    from repro_torch.core.ibp.predict import heldout_joint_loglik
    X_eval = torch.from_numpy(X[:8])
    ev = [float(heldout_joint_loglik(X_eval, gs.A[c], gs.pi[c], gs.active[c],
                                     gs.sigma_x[c], prng.fold_in(gs.key[c],
                                                                 999)))
          for c in range(4)]
    assert rec["joint_ll_eval"] == pytest.approx(np.mean(ev), rel=1e-6)
    # chains are independent: distinct trajectories
    assert len({round(s, 6) for s in rec["sigma_x_chains"]}) > 1
    # the trace has one (C,) row per iteration
    assert len(drv.trace["sigma_x"]) == 16
    assert drv.trace["sigma_x"][0].shape == (4,)


def test_checkpoint_chain_axis_must_match(X, tmp_path):
    cfg = DriverConfig(P=3, K_max=12, K_tail=6, L=2, n_iters=2,
                       ckpt_every=2, eval_every=100,
                       ckpt_dir=str(tmp_path / "a"))
    MCMCDriver(X, cfg, device="cpu").run()
    # chainless -> chained
    with pytest.raises(ValueError, match="chain"):
        MCMCDriver(X, dataclasses.replace(cfg, driver="multichain",
                                          n_chains=2, n_iters=4),
                   device="cpu").run()
    # chained -> chainless
    mc = _mc(tmp_path, "b", 2, ckpt_every=2)
    MCMCDriver(X, mc, device="cpu").run()
    with pytest.raises(ValueError, match="chain axis.*multichain"):
        MCMCDriver(X, dataclasses.replace(mc, driver="vmap", n_chains=1,
                                          n_iters=4), device="cpu").run()


def test_multichain_resume_rejects_changed_chain_count(X, tmp_path):
    MCMCDriver(X, _mc(tmp_path, "c", 2, ckpt_every=2), device="cpu").run()
    with pytest.raises(ValueError, match="n_chains"):
        MCMCDriver(X, _mc(tmp_path, "c", 4, c=5), device="cpu").run()


def test_multichain_checkpoints_cross_between_packages(X, tmp_path):
    # port -> reference: the reference's chained template reads the file
    drv = MCMCDriver(X, _mc(tmp_path, "p", 2, ckpt_every=2), device="cpu")
    gs, ss = drv.run()
    jdrv = JDriver(X, JConfig(P=3, K_max=12, K_tail=6, L=2,
                              driver="multichain", n_chains=C,
                              ckpt_dir=str(tmp_path / "p")))
    blob = jax_load_pytree(str(tmp_path / "p"), jdrv._template(), 2)
    np.testing.assert_array_equal(np.asarray(blob["Z_global"]),
                                  ss.Z.reshape(C, 48, 12).numpy())
    for f in ("A", "pi", "active", "alpha", "sigma_x", "sigma_a", "p_prime",
              "it", "overflow", "tail_sat"):
        np.testing.assert_array_equal(np.asarray(getattr(blob["gs"], f)),
                                      getattr(gs, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(blob["gs"].key)), gs.key.numpy())

    # reference -> port: a reference multichain checkpoint resumes
    jdir = tmp_path / "j"
    jgs, _ = JDriver(X, JConfig(P=3, K_max=12, K_tail=6, L=2, n_iters=2,
                                eval_every=2, driver="multichain",
                                n_chains=C, ckpt_dir=str(jdir),
                                seed=1)).run()
    drv = MCMCDriver(X, _mc(tmp_path, "j", 3), device="cpu")
    gs, ss = drv.run()
    assert gs.it.tolist() == [3] * C and drv.history[-1]["it"] == 3
    assert gs.key.shape == (C, 2)
    # the columns the port kept active are the reference's, or births
    assert float((gs.active.numpy() - np.asarray(jgs.active)).min()) >= -1


def test_multichain_grow_and_shrink_restores_per_chain(X, tmp_path):
    drv = MCMCDriver(X, _mc(tmp_path, "g", 2, ckpt_every=2), device="cpu")
    gs, ss = drv.run()
    blob = drv._template()
    # grow: K_max 12 -> 20, every chain padded with empty slots
    big = MCMCDriver(X, _mc(tmp_path, "g", 2, K_max=20), device="cpu")
    from repro_torch.checkpoint import restore
    g2, s2 = big._from_ckpt(restore(str(tmp_path / "g"),
                                    big._template())[0])
    assert s2.Z.shape == (C, 3, 16, 20) and g2.A.shape == (C, 20, X.shape[1])
    assert torch.equal(s2.Z[..., :12], ss.Z) and not s2.Z[..., 12:].any()
    assert torch.equal(g2.active[:, :12], gs.active)
    # shrink: each chain keeps its own live columns, in order
    k_small = int(gs.active.sum(-1).max()) + 1
    assert k_small < 12
    small = MCMCDriver(X, _mc(tmp_path, "g", 2, K_max=k_small, K_tail=1,
                              K_init=1), device="cpu")
    g3, s3 = small._from_ckpt(restore(str(tmp_path / "g"),
                                      small._template())[0])
    for c in range(C):
        live = torch.nonzero(gs.active[c] > 0.5).flatten()
        n = live.numel()
        assert torch.equal(g3.active[c, :n], gs.active[c, live])
        assert torch.equal(s3.Z[c][..., g3.active[c] > 0.5],
                           ss.Z[c][..., live])
        assert torch.equal(g3.A[c][g3.active[c] > 0.5], gs.A[c, live])
    # a shrink below some chain's live set is refused, naming the chain
    chains = {"gs": gs, "Z_global": ss.Z.reshape(C, 48, 12),
              "meta": {"it": gs.it}}
    save_pytree(str(tmp_path / "s"), chains, 2)
    n_max = int(gs.active.sum(-1).max())
    tiny = MCMCDriver(X, _mc(tmp_path, "s", 3, K_max=n_max - 1, K_tail=1,
                             K_init=1), device="cpu")
    with pytest.raises(ValueError, match="shrink.*chain"):
        tiny.run()
    assert blob["Z_global"].shape == (C, 48, 12)


def test_multichain_harvest_adds_a_sample_per_chain(X, tmp_path):
    drv = MCMCDriver(X, _mc(tmp_path, "h", 4, harvest_every=2,
                            harvest_burn=0.0), device="cpu")
    drv.run()
    bank = drv.bank
    assert bank.S == 2 * C
    assert sorted(bank.chain.tolist()) == sorted(list(range(C)) * 2)
    assert sorted(bank.it.tolist()) == [2] * C + [4] * C


def test_cli_runs_multichain_with_stale_sync(tmp_path, capsys):
    out = tmp_path / "hist.json"
    drv = mcmc.main(["--device", "cpu", "--N", "60", "--P", "2", "--iters",
                     "4", "--eval-every", "2", "--K-max", "8", "--L", "2",
                     "--driver", "multichain", "--chains", "3",
                     "--stale-sync", "1", "--ckpt-dir", str(tmp_path / "ck"),
                     "--out", str(out)])
    assert drv.spec.chains == "vmap" and drv.spec.n_chains == 3
    assert drv.spec.stale_sync == 1 and drv.spec.driver == "multichain"
    hist = json.loads(out.read_text())
    assert [r["it"] for r in hist] == [2, 4]
    for r in hist:
        assert len(r["K_chains"]) == 3 and np.isfinite(r["joint_ll_eval"])
    assert "it=    4" in capsys.readouterr().out
    # --driver mesh (--chains 2 by default) outside torch.distributed.run:
    # no group of C·P ranks to run on
    with pytest.raises(ValueError, match=r"n_chains=2, P=2 needs a "
                       r"torch.distributed group of 4 ranks.*\(2 chains x 2 "
                       r"data shards\).*no group"):
        mcmc.main(["--device", "cpu", "--driver", "mesh", "--N", "20",
                   "--P", "2", "--iters", "1",
                   "--ckpt-dir", str(tmp_path / "m"),
                   "--out", str(tmp_path / "m.json")])
