"""The port's posterior-predictive layer against the reference's.

* The bank: both builders give the same bank from the same samples
  (``chol_f`` to 1e-6, the rest exact), an npz written by either package
  loads in the other bitwise, and the port's ``load`` checks the format
  and the fields as the reference does.
* The batched scorer ``_score_bank`` on the reference's own per-sample
  draws (``jax.random.uniform(split(key, S)[s], (n_sweeps, K, B))``),
  masked and unmasked: 0 differing Z bits except float-boundary events,
  probs and row log-likelihoods to 1e-5 relative.
* The row joint log-likelihood in float64 against the port's copy of
  the numpy oracle and the reference's, to 1e-6.
* ``exact_posterior`` against the reference to 1e-5; ``encode`` against
  it within its Monte Carlo error; ``impute`` and ``anomaly_score``.
* The driver's harvest: cadence after burn-in, the bank saved with the
  checkpoints, a restart extending it, a rerun of the same object not
  duplicating it; ``SamplerSpec`` and ``DriverConfig`` carrying
  ``harvest_burn`` and ``bank_path``.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import bank_samples, scorer_divergence

from repro.checkpoint import load_arrays as jax_load_arrays
from repro.checkpoint import save_arrays as jax_save_arrays
from repro.core.ibp import predict as jp
from repro.runtime import DriverConfig as JConfig
from repro_torch.checkpoint import load_arrays, save_arrays, update_json
from repro_torch.core.ibp import IBPHypers, SamplerSpec
from repro_torch.core.ibp import predict as tp
from repro_torch.core.ibp.predict import BankBuilder, SampleBank
from repro_torch.interop import bank_from_reference
from repro_torch.runtime import DriverConfig, MCMCDriver

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(SampleBank)]


def _banks(K_max=16, lives=(5, 9, 7), D=12, sigma_x=0.6, seed=0,
           scale=1.0):
    """The same samples through the reference's builder and the port's."""
    jb, tb = jp.BankBuilder(K_max), BankBuilder(K_max)
    for kw in bank_samples(K_max, lives, D, sigma_x, seed, scale):
        jb.add(**kw)
        tb.add(**kw)
    return jb.build(), tb.build("cpu")


def _np_fields(bank) -> dict:
    return {f: np.asarray(getattr(bank, f)) for f in FIELDS}


def _ref_draws(key, S, n_sweeps, K, B) -> np.ndarray:
    keys = jax.random.split(key, S)
    return np.stack([np.asarray(jax.random.uniform(keys[s], (n_sweeps, K, B)))
                     for s in range(S)])


# --------------------------------------------------------------------------
# the bank
# --------------------------------------------------------------------------


@pytest.mark.parametrize("K_max,lives", [(16, (5, 5, 5)), (32, (2, 9, 4, 7)),
                                         (64, (0, 3)), (8, (8, 6))])
def test_bank_builders_agree_field_for_field(K_max, lives):
    jbank, tbank = _banks(K_max, lives)
    want, got = _np_fields(jbank), _np_fields(tbank)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype and got[f].shape == \
            want[f].shape, f
        if f == "chol_f":
            np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert tbank.K == jbank.K and tbank.S == jbank.S and tbank.D == jbank.D


def test_bank_packs_to_bucket_ladder():
    _, bank = _banks(K_max=64, lives=(5, 5, 5))
    assert bank.K == 8  # smallest bucket holding 5 live features
    _, bank = _banks(K_max=32, lives=(2, 9, 4, 7))
    assert bank.K == 16


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bank_npz_crosses_between_packages(tmp_path, writer):
    jbank, tbank = _banks(K_max=32, lives=(2, 9, 4, 7), seed=7)
    path = str(tmp_path / "bank.npz")
    if writer == "port":
        tbank.save(path)
        back = _np_fields(jp.SampleBank.load(path))
        want = _np_fields(tbank)
    else:
        jbank.save(path)
        back = _np_fields(SampleBank.load(path, device="cpu"))
        want = _np_fields(jbank)
    for f in FIELDS:
        assert back[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(back[f], want[f], err_msg=f)


@pytest.mark.parametrize("arrays,match", [
    ({"_format": np.asarray(99), "A": np.zeros((1, 2, 2))}, "format"),
    ({"_format": np.asarray(1, np.int32), "A": np.zeros((1, 2, 2))},
     "missing")])
def test_bank_load_rejects_wrong_format_and_missing_fields(tmp_path, arrays,
                                                           match):
    path = str(tmp_path / "bad.npz")
    save_arrays(path, arrays)
    with pytest.raises(ValueError, match=match):
        SampleBank.load(path, device="cpu")
    with pytest.raises(ValueError, match=match):
        jp.SampleBank.load(path)


def test_empty_builder_build_raises():
    with pytest.raises(ValueError, match="empty bank"):
        BankBuilder(8).build("cpu")


def test_bank_load_needs_a_gpu_unless_told_cpu(monkeypatch, tmp_path):
    _, bank = _banks()
    path = bank.save(str(tmp_path / "bank.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SampleBank.load(path)
    bb = BankBuilder(16)
    bb.add(**bank_samples(16, (3,), 12)[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bb.build()


def test_extend_from_and_prune_after_keep_the_reference_bank():
    jbank, tbank = _banks(K_max=32, lives=(2, 9, 4, 7), seed=3)
    jb, tb = jp.BankBuilder(32), BankBuilder(32)
    jb.extend_from(jbank)
    tb.extend_from(tbank)
    assert jb.prune_after(11) == tb.prune_after(11) == 2
    want, got = _np_fields(jb.build()), _np_fields(tb.build("cpu"))
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("chains", [0, 3])
def test_add_state_harvests_as_the_reference(chains):
    """A chainless state gives one sample; a chain-batched one (leading
    chain axis) one per chain, each tagged with its chain."""
    rng = np.random.default_rng(4)
    lead = (chains,) if chains else ()
    act = (rng.random((*lead, 16)) < 0.5).astype(np.float32)
    fields = dict(A=rng.standard_normal((*lead, 16, 6)).astype(np.float32),
                  pi=rng.uniform(0.1, 0.9, (*lead, 16)).astype(np.float32),
                  active=act,
                  sigma_x=rng.uniform(0.4, 0.8, lead).astype(np.float32),
                  sigma_a=np.ones(lead, np.float32),
                  alpha=np.full(lead, 2.0, np.float32))
    jgs = type("GS", (), {k: jnp.asarray(v) for k, v in fields.items()})
    tgs = type("GS", (), {k: torch.from_numpy(v) for k, v in fields.items()})
    jb, tb = jp.BankBuilder(16), BankBuilder(16)
    assert jb.add_state(jgs, it=7) == tb.add_state(tgs, it=7) == max(chains, 1)
    want, got = _np_fields(jb.build()), _np_fields(tb.build("cpu"))
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-6,
                                   err_msg=f)


def test_bank_from_reference_is_the_reference_bank():
    jbank, _ = _banks(seed=5)
    got = _np_fields(bank_from_reference(_np_fields(jbank), device="cpu"))
    for f, v in _np_fields(jbank).items():
        assert got[f].dtype == v.dtype, f
        np.testing.assert_array_equal(got[f], v, err_msg=f)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_arrays_crosses_between_packages(tmp_path, writer):
    arrs = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.asarray(3, np.int32)}
    path = str(tmp_path / "sub" / "x.npz")
    (save_arrays if writer == "port" else jax_save_arrays)(path, arrs)
    for load in (load_arrays, jax_load_arrays):
        back = load(path)
        for k, v in arrs.items():
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)
    assert not (tmp_path / "sub" / "x.npz.tmp").exists()


def test_update_json_merges_and_tolerates_a_corrupt_file(tmp_path):
    path = tmp_path / "b.json"
    path.write_text("{not json")
    update_json(str(path), lambda d: {**d, "x": [1]})
    update_json(str(path), lambda d: {**d, "y": d["x"] + [2]})
    assert json.loads(path.read_text()) == {"x": [1], "y": [1, 2]}


# --------------------------------------------------------------------------
# the batched scorer on the reference's own draws
# --------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("K_max,lives,D,B,n_sweeps,sigma_x", [
    (16, (5, 9, 7), 12, 9, 6, 0.6),
    (32, (12, 3, 17, 1), 40, 16, 3, 0.9),
])
def test_score_bank_matches_reference_on_its_draws(masked, K_max, lives, D,
                                                   B, n_sweeps, sigma_x):
    """0 differing Z bits except float-boundary events (margin < 1e-4 on
    the row's chain); probs and row log-likelihoods to 1e-5 relative
    (probs, in [0, 1], with atol 1e-6) on every other chain."""
    jbank, tbank = _banks(K_max, lives, D, sigma_x, seed=B)
    rng = np.random.default_rng(B + 1)
    X = rng.standard_normal((B, D)).astype(np.float32)
    mask = ((rng.random((B, D)) > 0.3).astype(np.float32) if masked
            else None)
    key = jax.random.key(4)
    rb = n_sweeps // 2
    jprobs, jZ, jll = (np.asarray(a) for a in jp._score_bank(
        jbank, jnp.asarray(X), jp._as_mask(jnp.asarray(X), mask), key,
        n_sweeps, rb, masked=masked))
    u = _ref_draws(key, jbank.S, n_sweeps, jbank.K, B)
    probs, Z, ll = (t.numpy() for t in tp._score_bank(
        tbank, torch.from_numpy(X),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(u), n_sweeps, rb))
    assert probs.shape == Z.shape == (tbank.S, B, tbank.K)
    assert ll.shape == (tbank.S, B)
    events, n_bits = scorer_divergence(_np_fields(jbank), X, mask, u,
                                       n_sweeps, jZ, Z)
    assert n_bits == 0 or events, n_bits
    same = np.ones((tbank.S, B), bool)
    for s, b, _ in events:
        same[s, b] = False
    np.testing.assert_allclose(probs[same], jprobs[same], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ll[same], jll[same], rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_rows_joint_loglik_float64_matches_numpy_oracles(masked):
    """The batched row joint in float64 against the port's copy of the
    numpy oracle and the reference's, to 1e-6; the mixture likewise."""
    _, bank32 = _banks(K_max=8, lives=(5, 5, 5), D=7, seed=9)
    bank = SampleBank(**{f: getattr(bank32, f).double()
                         if getattr(bank32, f).is_floating_point()
                         else getattr(bank32, f) for f in FIELDS})
    rng = np.random.default_rng(9)
    X = torch.from_numpy(rng.standard_normal((4, 7)))
    mask = (torch.from_numpy((rng.random((4, 7)) > 0.3).astype(np.float64))
            if masked else None)
    u = torch.from_numpy(rng.random((3, 3, bank.K, 4)))
    _, Z, lls = tp._score_bank(bank, X, mask, u, 3, 1)
    assert lls.dtype == torch.float64
    for oracle in (tp.joint_loglik_np, jp.joint_loglik_np):
        want = np.stack([
            oracle(X.numpy(), Z[s].numpy(), bank.A[s].numpy(),
                   bank.pi[s].numpy(), bank.active[s].numpy(),
                   float(bank.sigma_x[s]),
                   mask=None if mask is None else mask.numpy())
            for s in range(bank.S)])
        np.testing.assert_allclose(lls.numpy(), want, rtol=1e-6, atol=1e-6)
    got, per = tp.predictive_loglik(bank, X, torch.tensor([0, 4],
                                                          dtype=torch.uint32),
                                    mask=mask, per_sample=True)
    mix = torch.logsumexp(per, 0) - np.log(bank.S)
    np.testing.assert_allclose(got.numpy(), mix.numpy(), rtol=1e-12)


# --------------------------------------------------------------------------
# the enumeration oracle and the public ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_exact_posterior_matches_reference(masked):
    jbank, tbank = _banks(K_max=16, lives=(6, 10), D=9, sigma_x=0.8,
                          seed=12)
    rng = np.random.default_rng(13)
    X = rng.standard_normal((5, 9)).astype(np.float32)
    mask = ((rng.random((5, 9)) > 0.4).astype(np.float32) if masked
            else None)
    for s in range(tbank.S):
        want = jp.exact_posterior(jbank.A[s], jbank.pi[s], jbank.active[s],
                                  jbank.sigma_x[s], X, mask=mask)
        got = tp.exact_posterior(tbank.A[s], tbank.pi[s], tbank.active[s],
                                 tbank.sigma_x[s], X, mask=mask)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_exact_posterior_rejects_large_k():
    A = np.zeros((tp.ENUM_MAX_K + 1, 4), np.float32)
    with pytest.raises(ValueError, match="enumeration"):
        tp.exact_posterior(A, np.zeros(A.shape[0]), np.zeros(A.shape[0]),
                           1.0, np.zeros((2, 4), np.float32))


# the RB estimate of a marginal averages n_sweeps // 2 conditional
# probabilities in [0, 1]: its standard error is at most 0.5 / sqrt(kept),
# and 4 of them bound the error of an estimate from independent sweeps
@pytest.mark.parametrize("masked", [False, True])
def test_encode_matches_enumeration_within_mc_error(masked):
    n_sweeps = 192
    tol = 4 * 0.5 / np.sqrt(n_sweeps // 2)
    _, bank = _banks(K_max=8, lives=(4, 3), D=6, sigma_x=0.8, seed=1)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((5, 6)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((5, 6)) > 0.4).astype(np.float32)
        mask[:, 0] = 1.0
    probs = tp.encode(bank, X, torch.tensor([0, 1], dtype=torch.uint32),
                      mask=mask, n_sweeps=n_sweeps)
    assert probs.shape == (bank.S, 5, bank.K)
    for s in range(bank.S):
        marg, _, _ = tp.exact_posterior(bank.A[s], bank.pi[s],
                                        bank.active[s], bank.sigma_x[s], X,
                                        mask=mask)
        err = float((probs[s] - marg).abs().max())
        assert err < tol, f"sample {s}: RB marginals off by {err}"


def test_impute_passes_observed_entries_and_meets_the_sigma_zero_limit():
    """Observed entries pass through bitwise; at sigma_x -> 0 the missing
    ones equal the exact conditional mean and the planted row."""
    rng = np.random.default_rng(5)
    K_max, D = 8, 10
    A = np.zeros((K_max, D), np.float32)
    A[:3] = rng.standard_normal((3, D))
    act = (np.arange(K_max) < 3).astype(np.float32)
    bb = BankBuilder(K_max)
    bb.add(A, 0.5 * act, act, 0.02, 1.0, 2.0)
    bank = bb.build("cpu")
    x_full = np.array([1.0, 0.0, 1.0]) @ A[:3]
    mask = np.ones((1, D), np.float32)
    mask[0, 6:] = 0.0
    X = (x_full * mask[0]).reshape(1, D).astype(np.float32)
    out = tp.impute(bank, X, mask, torch.tensor([0, 2], dtype=torch.uint32),
                    n_sweeps=24).numpy()
    _, _, cond = tp.exact_posterior(bank.A[0], bank.pi[0], bank.active[0],
                                    bank.sigma_x[0], X, mask=mask)
    miss = mask[0] < 0.5
    np.testing.assert_array_equal(out[0, ~miss], X[0, ~miss])
    np.testing.assert_allclose(out[0, miss], cond.numpy()[0, miss],
                               atol=1e-2)
    np.testing.assert_allclose(out[0, miss], x_full[miss], atol=1e-2)
    full = tp.impute(bank, X, None, torch.tensor([0, 2], dtype=torch.uint32))
    np.testing.assert_array_equal(full.numpy(), X)


def test_anomaly_is_negative_mixture():
    _, bank = _banks()
    X = np.random.default_rng(11).standard_normal((3, 12)).astype(np.float32)
    key = torch.tensor([0, 5], dtype=torch.uint32)
    np.testing.assert_array_equal(tp.anomaly_score(bank, X, key).numpy(),
                                  -tp.predictive_loglik(bank, X, key).numpy())


@pytest.mark.parametrize("op,shape", [
    ("encode", lambda S, B, K, D: (S, B, K)),
    ("impute", lambda S, B, K, D: (B, D)),
    ("loglik", lambda S, B, K, D: (B,)),
    ("per_sample", lambda S, B, K, D: (S, B))])
def test_public_ops_return_the_reference_shapes(op, shape):
    _, bank = _banks()
    rng = np.random.default_rng(14)
    X = rng.standard_normal((6, 12)).astype(np.float32)
    mask = (rng.random((6, 12)) > 0.3).astype(np.float32)
    key = torch.tensor([0, 9], dtype=torch.uint32)
    out = {"encode": lambda: tp.encode(bank, X, key),
           "impute": lambda: tp.impute(bank, X, mask, key),
           "loglik": lambda: tp.predictive_loglik(bank, X, key),
           "per_sample": lambda: tp.predictive_loglik(
               bank, X, key, per_sample=True)[1]}[op]()
    assert tuple(out.shape) == shape(bank.S, 6, bank.K, bank.D)
    assert torch.isfinite(out).all()


def test_naive_loop_finite_shaped_and_near_the_batched_scorer():
    _, bank = _banks(K_max=8, lives=(3, 4), D=8, sigma_x=0.6, seed=6)
    X = np.random.default_rng(12).standard_normal((5, 8)).astype(np.float32)
    key = torch.tensor([0, 6], dtype=torch.uint32)
    out = tp.predictive_loglik_naive(bank, X, key)
    assert out.shape == (5,) and torch.isfinite(out).all()
    # both estimate the same mixture, each from a few Gibbs sweeps
    ref = tp.predictive_loglik(bank, X, key, n_sweeps=32)
    assert float((out - ref).abs().max()) < 0.1 * float(ref.abs().max())


# --------------------------------------------------------------------------
# harvest wiring: spec, DriverConfig, driver
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(harvest_every=-1), "harvest_every"),
    (dict(harvest_burn=1.0), "harvest_burn"),
    (dict(harvest_burn=-0.1), "harvest_burn")])
def test_spec_validates_harvest_knobs(kw, match):
    with pytest.raises(ValueError, match=match):
        SamplerSpec(**kw)


def test_spec_and_driver_config_carry_the_harvest_fields():
    spec = SamplerSpec(harvest_every=5, harvest_burn=0.0, bank_path="b.npz")
    assert (spec.harvest_every, spec.harvest_burn, spec.bank_path) == \
        (5, 0.0, "b.npz")
    kw = dict(harvest_every=3, harvest_burn=0.25, bank_path="x/bank.npz")
    got, want = DriverConfig(**kw).to_spec(), JConfig(**kw).to_spec()
    for f in ("harvest_every", "harvest_burn", "bank_path"):
        assert getattr(got, f) == getattr(want, f) == kw[f]


def _harvest_spec(tmp_path, **kw):
    base = dict(P=2, K_max=8, K_tail=4, K_init=2, L=2, eval_every=4,
                ckpt_every=2, ckpt_dir=str(tmp_path / "ck"),
                harvest_every=1, harvest_burn=0.0,
                bank_path=str(tmp_path / "bank.npz"))
    base.update(kw)
    return SamplerSpec(**base)


def test_driver_harvests_bank(tmp_path):
    """A run harvests past burn-in at cadence, the bank rides the
    checkpoint cadence, and the saved npz scores with no sampler."""
    X = np.random.default_rng(13).standard_normal((24, 5)).astype(np.float32)
    spec = _harvest_spec(tmp_path, n_iters=8, ckpt_every=4,
                         harvest_every=2, harvest_burn=0.25)
    drv = MCMCDriver(X, spec, IBPHypers(), device="cpu")
    gs, _ = drv.run()
    # burn = int(0.25 * 8) = 2: harvests at iterations 4, 6 and 8
    assert len(drv.bank_builder) == 3
    bank = SampleBank.load(spec.bank_path, device="cpu")
    assert bank.S == 3 and bank.K <= 8
    assert bank.it.tolist() == [4, 6, 8] and bank.chain.tolist() == [0] * 3
    # the last sample is the final state's draw
    k = int(gs.active.sum())
    assert int(bank.active[-1].sum()) == k
    live = gs.active > 0.5
    np.testing.assert_array_equal(bank.A[-1, :k].numpy(), gs.A[live].numpy())
    ll = tp.predictive_loglik(bank, X[:4], torch.tensor([0, 0],
                                                        dtype=torch.uint32))
    assert torch.isfinite(ll).all()
    assert drv.bank is not None and drv.bank.S == 3


def test_driver_restart_extends_bank(tmp_path):
    """A restart re-seeds the builder from the saved bank instead of
    overwriting it with a shorter ensemble."""
    X = np.random.default_rng(14).standard_normal((16, 4)).astype(np.float32)
    spec = _harvest_spec(tmp_path, n_iters=4)
    drv = MCMCDriver(X, spec, IBPHypers(), device="cpu")
    with pytest.raises(RuntimeError, match="injected crash"):
        drv.run(crash_at=3)  # harvested 1, 2, 3; checkpoint and bank at 2
    MCMCDriver(X, spec, IBPHypers(), device="cpu").run()
    bank = SampleBank.load(spec.bank_path, device="cpu")
    assert bank.S == 4
    assert sorted(bank.it.tolist()) == [1, 2, 3, 4]


def test_same_driver_rerun_does_not_duplicate_harvests(tmp_path):
    """Retrying run() on the same object rewinds to the checkpoint and
    harvests the rewound iterations again: each draw stays once."""
    X = np.random.default_rng(21).standard_normal((16, 4)).astype(np.float32)
    spec = _harvest_spec(tmp_path, n_iters=4)
    drv = MCMCDriver(X, spec, IBPHypers(), device="cpu")
    with pytest.raises(RuntimeError, match="injected crash"):
        drv.run(crash_at=3)
    drv.run()
    its = sorted(SampleBank.load(spec.bank_path, device="cpu").it.tolist())
    assert its == [1, 2, 3, 4], its


def test_driver_without_harvest_writes_no_bank(tmp_path):
    X = np.random.default_rng(15).standard_normal((16, 4)).astype(np.float32)
    drv = MCMCDriver(X, _harvest_spec(tmp_path, n_iters=2, harvest_every=0),
                     IBPHypers(), device="cpu")
    drv.run()
    assert drv.bank_builder is None and drv.bank is None
    assert drv.save_bank() is None
    assert not (tmp_path / "bank.npz").exists()
