"""The port's capacity restarts, adaptive K_tail and DriverConfig against
the reference's.

* Grow and shrink restore: one reference-written checkpoint restored
  under a larger and a smaller K_max gives the reference's state
  bitwise, in both packages; a shrink below the live set raises in both.
* Adaptive K_tail: ``_maybe_grow_tail`` makes the reference's decision
  on one state carried over by ``interop.from_reference``.
* ``DriverConfig.to_spec`` gives the reference's values for every field
  the port's spec has, and refuses what is not ported.

The reference's seed-based overflow test does not overflow under the
installed JAX, so the overflow here is forced, as in test_torch_driver.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.data import cambridge_data
from repro.runtime import DriverConfig as JConfig
from repro.runtime import MCMCDriver as JDriver
from repro_torch.checkpoint import restore, save_pytree
from repro_torch.core.ibp import SamplerSpec
from repro_torch.interop import from_reference
from repro_torch.launch import mcmc
from repro_torch.runtime import DriverConfig, MCMCDriver, as_spec

torch.set_num_threads(1)

BASE = dict(P=2, K_max=12, K_tail=4, L=2, n_iters=10, ckpt_every=3,
            eval_every=3, overflow_every=1, seed=1)


@pytest.fixture(scope="module")
def X():
    return cambridge_data(N=48, sigma_n=0.5, seed=3)[0]


def _np_fields(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "key":
            v = jax.random.key_data(v)
        out[f.name] = np.asarray(v)
    return out


def _forced_overflow(step, at_it: int):
    """``step`` with one dropped feature added at iteration ``at_it``."""
    def overflowing_step(gs, ss):
        gs, ss = step(gs, ss)
        if int(gs.it) == at_it:
            gs = dataclasses.replace(gs, overflow=gs.overflow + 1)
        return gs, ss
    return overflowing_step


@pytest.fixture(scope="module")
def ref_ckpts(tmp_path_factory, X):
    """Two reference checkpoints of one run: "clean" (step 3, overflow 0)
    and "overflowed" (step 4, written by the reference's overflow path
    with overflow 1). Its live columns are 0, 1 and 3."""
    root = tmp_path_factory.mktemp("ref")
    run_dir = root / "run"
    jdrv = JDriver(X, JConfig(**BASE, ckpt_dir=str(run_dir)))
    jdrv.sampler.step = _forced_overflow(jdrv.sampler.step, 4)
    with pytest.raises(RuntimeError, match="overflow at it=3"):
        jdrv.run()
    dirs = {}
    for name, step in (("clean", 3), ("overflowed", 4)):
        d = root / name
        d.mkdir()
        f = f"step_{step:09d}.npz"
        shutil.copy(run_dir / f, d / f)
        dirs[name] = d
    return dirs


def _restore_both(X, ckpt_dir, **kw):
    """The reference's and the port's ``_from_ckpt`` of ``ckpt_dir``
    under ``BASE`` updated by ``kw`` (K_init and K_tail cut to fit the
    smallest capacity)."""
    cfg = dict(BASE, ckpt_dir=str(ckpt_dir), K_init=1, K_tail=2, **kw)
    jdrv = JDriver(X, JConfig(**cfg))
    jgs, jss = jdrv._from_ckpt(jax_restore(str(ckpt_dir),
                                           jdrv._template())[0])
    drv = MCMCDriver(X, DriverConfig(**cfg), device="cpu")
    gs, ss = drv._from_ckpt(restore(str(ckpt_dir), drv._template())[0])
    return (jgs, jss), (gs, ss)


LIVE = 3  # live features in both reference checkpoints


@pytest.mark.parametrize("ckpt", ["clean", "overflowed"])
@pytest.mark.parametrize("K_max", [24, LIVE + 2, LIVE])
def test_restore_into_another_capacity_matches_reference(ref_ckpts, X,
                                                         ckpt, K_max):
    (jgs, jss), (gs, ss) = _restore_both(X, ref_ckpts[ckpt], K_max=K_max)
    assert int(np.sum(np.asarray(jgs.active))) == LIVE
    want, got = _np_fields(jgs), {k: v.numpy() for k, v in vars(gs).items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("Z", "Z_tail", "tail_active"):
        np.testing.assert_array_equal(getattr(ss, k).numpy(),
                                      np.asarray(getattr(jss, k)), err_msg=k)
    assert ss.Z.shape[-1] == K_max
    # a grow resets the overflow count; a shrink keeps it, as the reference
    assert int(gs.overflow) == (ckpt == "overflowed" and K_max < 12)


def test_shrink_below_live_features_refused_by_both(ref_ckpts, X):
    cfg = dict(BASE, K_max=LIVE - 1, K_tail=2, K_init=1, ckpt_dir=str(
        ref_ckpts["clean"]))
    with pytest.raises(ValueError, match="shrink"):
        JDriver(X, JConfig(**cfg)).run()
    with pytest.raises(ValueError, match="shrink"):
        MCMCDriver(X, DriverConfig(**cfg), device="cpu").run()


@pytest.mark.parametrize("ckpt,K_max", [("overflowed", 24),
                                        ("clean", LIVE + 5)])
def test_port_resumes_after_restore_into_another_capacity(
        tmp_path, ref_ckpts, X, ckpt, K_max):
    d = tmp_path / "ck"
    shutil.copytree(ref_ckpts[ckpt], d)
    start = int(os.listdir(d)[0][5:14])
    drv = MCMCDriver(X, DriverConfig(**dict(BASE, K_max=K_max, n_iters=8,
                                            ckpt_dir=str(d))), device="cpu")
    gs, ss = drv.run()
    assert int(gs.it) == 8 and [r["it"] for r in drv.history][0] > start
    assert ss.Z.shape[-1] == K_max and gs.A.shape[0] == K_max
    assert int(gs.overflow) == 0
    assert np.isfinite(drv.history[-1]["joint_ll_train"])


def test_chain_axis_checkpoint_refused(tmp_path, X):
    # a checkpoint in the multichain layout (every leaf with a leading
    # chain axis) under a chainless spec is refused, naming the driver
    # that restores it, not reshaped
    drv = MCMCDriver(X, DriverConfig(P=2, K_max=8, ckpt_dir=str(tmp_path)),
                     device="cpu")
    blob = drv._template()
    chains = {"gs": dataclasses.replace(blob["gs"], **{
        k: torch.stack([v, v]) for k, v in vars(blob["gs"]).items()}),
        "Z_global": torch.stack([blob["Z_global"]] * 2),
        "meta": {"it": torch.stack([blob["meta"]["it"]] * 2)}}
    save_pytree(str(tmp_path), chains, 1)
    with pytest.raises(ValueError,
                       match="chain axis.*multichain.*n_chains=2"):
        drv.run()


def test_restore_takes_leaf_shapes_from_the_file(tmp_path, X):
    # both restore paths read the checkpoint's K, not the template's
    small = MCMCDriver(X, DriverConfig(P=2, K_max=8, K_tail=4),
                       device="cpu")
    gs, ss = small.sampler.init()
    save_pytree(str(tmp_path), small._to_ckpt(gs, ss), 1)
    big = MCMCDriver(X, DriverConfig(P=2, K_max=16, K_tail=4), device="cpu")
    blob, step = restore(str(tmp_path), big._template())
    assert step == 1
    assert tuple(blob["Z_global"].shape) == (48, 8)
    assert tuple(blob["gs"].A.shape) == (8, X.shape[1])
    assert tuple(blob["gs"].pi.shape) == tuple(blob["gs"].active.shape) \
        == (8,)
    np.testing.assert_array_equal(blob["Z_global"].numpy(),
                                  ss.Z.reshape(48, 8).numpy())


def test_forced_overflow_grows_and_finishes(tmp_path, X):
    """Overflow checkpoints and raises; restarts at twice K_max resume
    from that checkpoint and finish with the feature axis grown."""
    cfg = DriverConfig(**dict(BASE, K_max=8, K_tail=2, K_init=2, n_iters=8,
                              ckpt_every=100, eval_every=100,
                              ckpt_dir=str(tmp_path)))
    drv = MCMCDriver(X, cfg, device="cpu")
    drv.sampler.step = _forced_overflow(drv.sampler.step, 3)
    with pytest.raises(RuntimeError, match="overflow at it=2"):
        drv.run()
    assert os.listdir(tmp_path) == ["step_000000003.npz"]
    K = cfg.K_max
    for _ in range(3):
        K *= 2
        try:
            drv = MCMCDriver(X, dataclasses.replace(cfg, K_max=K),
                             device="cpu")
            gs, ss = drv.run()
            break
        except RuntimeError as e:
            assert "overflow" in str(e)
    else:
        pytest.fail("growth never reached sufficient capacity")
    assert int(gs.it) == 8 and ss.Z.shape[-1] == K
    assert int(gs.overflow) == 0
    assert [r["it"] for r in drv.history] == [8]


# (K_max, K_tail, k_tail_grow, growths so far, _sat_mark, tail_sat)
GROW_CASES = {
    "new_saturation": (16, 4, 2, 0, 0, 3),
    "at_or_below_mark": (16, 4, 2, 0, 3, 3),
    "doublings_exhausted": (16, 4, 2, 2, 0, 3),
    "clipped_to_K_max": (12, 8, 2, 0, 0, 1),
    "K_tail_is_K_max": (8, 8, 2, 0, 0, 5),
}


@pytest.mark.parametrize("case", list(GROW_CASES))
def test_maybe_grow_tail_decides_as_reference(tmp_path, X, case):
    K_max, K_tail, grow, growths, mark, sat = GROW_CASES[case]
    cfg = dict(P=2, K_max=K_max, K_tail=K_tail, k_tail_grow=grow,
               ckpt_dir=str(tmp_path))
    jdrv = JDriver(X, JConfig(**cfg))
    jgs, st = jdrv.sampler.init(jax.random.key(0))
    jgs = dataclasses.replace(jgs, tail_sat=jnp.asarray(sat, jnp.int32))
    jss = jdrv.sampler.to_canonical(st)
    drv = MCMCDriver(X, DriverConfig(**cfg), device="cpu")
    gs, ss = from_reference(_np_fields(jgs), _np_fields(jss), device="cpu")
    for d in (jdrv, drv):
        d._tail_growths, d._sat_mark = growths, mark
    jgs, jss, jgrew = jdrv._maybe_grow_tail(jgs, jss)
    gs, ss, grew = drv._maybe_grow_tail(gs, ss)
    assert grew == jgrew == (case in ("new_saturation", "clipped_to_K_max"))
    assert drv.spec.K_tail == jdrv.spec.K_tail
    assert drv.sampler.spec == drv.spec
    assert tuple(ss.Z_tail.shape) == tuple(jss.Z_tail.shape)
    assert tuple(ss.tail_active.shape) == tuple(jss.tail_active.shape)
    assert int(gs.tail_sat) == int(jgs.tail_sat)
    assert drv._tail_growths == jdrv._tail_growths
    assert drv._sat_mark == jdrv._sat_mark
    np.testing.assert_array_equal(ss.Z.numpy(), np.asarray(jss.Z))


def test_grown_sampler_shares_the_data(X):
    drv = MCMCDriver(X, DriverConfig(P=2, K_max=16, K_tail=4,
                                     k_tail_grow=1), device="cpu")
    s = drv.sampler
    t = s.with_spec(s.spec.replace(K_tail=8))
    assert t.Xs is s.Xs and t.spec.K_tail == 8 and s.spec.K_tail == 4
    with pytest.raises(ValueError, match="P=3"):
        s.with_spec(s.spec.replace(P=3))


def test_adaptive_k_tail_grows_on_saturation(tmp_path):
    """The port's run of the reference's
    test_driver.py::test_adaptive_k_tail_grows_on_saturation."""
    rng = np.random.default_rng(0)
    Zt = (rng.random((60, 10)) < 0.4).astype(np.float32)
    At = rng.standard_normal((10, 16)).astype(np.float32) * 1.5
    X = Zt @ At + 0.3 * rng.standard_normal((60, 16)).astype(np.float32)
    cfg = DriverConfig(P=3, K_max=16, K_tail=1, K_init=1, L=3, n_iters=30,
                       ckpt_every=5, eval_every=10, k_tail_grow=3,
                       alpha=8.0, ckpt_dir=str(tmp_path))
    drv = MCMCDriver(X, cfg, device="cpu")
    gs, ss = drv.run()
    assert int(gs.it) == 30
    assert drv.spec.K_tail > 1
    assert drv.spec.K_tail <= cfg.K_max
    assert ss.Z_tail.shape[-1] == drv.spec.K_tail
    rec = drv.history[-1]
    assert rec["K_tail"] == drv.spec.K_tail
    assert rec["tail_sat"] >= 0
    assert drv._tail_growths <= cfg.k_tail_grow


def test_driver_config_maps_onto_the_reference_spec(tmp_path):
    kw = dict(P=3, K_max=24, K_tail=6, L=4, n_iters=50, ckpt_every=7,
              ckpt_dir=str(tmp_path), eval_every=5, seed=9, alpha=2.5,
              sigma_x=0.7, sigma_a=1.3, K_init=2, backend="pallas",
              overflow_every=3, k_tail_grow=2, collapsed_backend="pallas",
              chol_refresh=16, k_live_buckets="off")
    for cfg_kw in ({}, kw, dict(kw, driver="multichain", n_chains=3,
                                stale_sync=2)):
        ref = JConfig(**cfg_kw).to_spec()
        spec = DriverConfig(**cfg_kw).to_spec()
        assert isinstance(spec, SamplerSpec)
        for f in dataclasses.fields(spec):
            assert getattr(spec, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(DriverConfig)} == \
        {f.name for f in dataclasses.fields(JConfig)}
    spec = SamplerSpec(P=2)
    assert as_spec(spec) is spec
    drv = MCMCDriver(cambridge_data(N=20, seed=0)[0],
                     DriverConfig(P=2, K_max=8), device="cpu")
    assert drv.cfg is drv.spec and drv.spec.K_max == 8


# driver="shardmap" and driver="mesh" map onto the reference's spec
# (devices_needed P and C·P), and the driver refuses them in a process
# that is not a rank of a group of that many (here there is no group)
@pytest.mark.parametrize("kw,chains", [
    (dict(driver="shardmap"), "none"), (dict(driver="mesh"), "mesh"),
    (dict(driver="mesh", n_chains=2), "mesh"),
    (dict(driver="shardmap", sync="fused"), "none"),
    (dict(driver="mesh", sync="fused", n_chains=4), "mesh"),
    (dict(driver="shardmap", stale_sync=1), "none"),
    (dict(driver="mesh", n_chains=2, stale_sync=1), "mesh")],
    ids=["shardmap", "mesh", "mesh-C2", "shardmap-fused", "mesh-fused-C4",
         "shardmap-stale1", "mesh-C2-stale1"])
def test_driver_config_maps_layout_and_refuses_outside_its_group(kw, chains,
                                                                  X):
    spec, ref = DriverConfig(**kw).to_spec(), JConfig(**kw).to_spec()
    C = kw.get("n_chains", 1)
    got = (spec.chains, spec.n_chains, spec.data, spec.sync, spec.stale_sync,
           spec.devices_needed)
    assert got == (chains, C, "shardmap", kw.get("sync", "staged"),
                   kw.get("stale_sync", 0), 4 * C)
    assert got == (ref.chains, ref.n_chains, ref.data, ref.sync,
                   ref.stale_sync, ref.devices_needed)
    with pytest.raises(ValueError, match=(
            rf"P=4 needs a torch.distributed group of {4 * C} ranks: "
            rf"driver='{kw['driver']}' needs {4 * C} devices \({C} chains "
            rf"x 4 data shards\).*is in no group \(0 ranks\)")):
        MCMCDriver(X, DriverConfig(**kw), device="cpu")


@pytest.mark.parametrize("kw", [dict(driver="bogus"), dict(backend="cuda"),
                                dict(collapsed_backend="x"),
                                dict(k_live_buckets="maybe"),
                                dict(sync="x"), dict(harvest_burn=1.0)])
def test_driver_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        JConfig(**kw).to_spec()
    with pytest.raises(ValueError, match="DriverConfig"):
        DriverConfig(**kw).to_spec()


# layout values the reference's spec validation rejects, rejected by the
# port's spec in the same words
@pytest.mark.parametrize("kw,words", [
    (dict(n_chains=2), "needs a chain axis"),
    (dict(sync="fused"), "is a collective schedule"),
    (dict(driver="multichain", n_chains=0), "must be >= 1")])
def test_driver_config_rejects_layouts_as_the_reference_does(kw, words):
    with pytest.raises(ValueError, match=words):
        JConfig(**kw).to_spec()
    with pytest.raises(ValueError, match=f"SamplerSpec: .*{words}"):
        DriverConfig(**kw).to_spec()


def test_cli_takes_k_tail_grow(tmp_path):
    out = tmp_path / "hist.json"
    drv = mcmc.main(["--device", "cpu", "--N", "60", "--P", "2", "--iters",
                     "4", "--eval-every", "2", "--K-max", "8", "--K-tail",
                     "2", "--k-tail-grow", "3", "--L", "2",
                     "--ckpt-dir", str(tmp_path / "ck"), "--out", str(out)])
    assert drv.spec.k_tail_grow == 3
    assert [r["it"] for r in drv.history] == [2, 4]
    assert all(r["K_tail"] == 2 for r in drv.history)  # no boundary yet
