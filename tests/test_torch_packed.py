"""The port's packed collapsed carry against the reference's.

* The block helpers (``g_rank1``, ``live_buckets``, ``pick_bucket``,
  ``block_select``) against reference ``math.py`` on numpy inputs.
* The rss flip (``collapsed_row_flip_fast``) with and without a passed
  G against the reference's ``fast.py`` on identical inputs: decisions
  equal, (v, q, mean) at float32 tolerance.
* The plain segment scan (``collapsed_scan`` on CPU tensors) against the
  reference's ``_packed_scan`` on a block B < K_can, in the ``"fast"``
  flavor (rss flip, carried G; the reference's ``"packed"`` with
  ``carry_g=True``) and the ``"pallas"`` flavor, with Gibbs and with MH
  births, fed the reference's own draws (``jax_draws``): decisions within
  MISMATCH_BUDGET, ZᵀZ and m exact, the refresh count and ``ovf_row``
  equal, including cases built to overflow (a bucket whose only free
  slots are the PACK_HEADROOM ones, births common).
* The packed sweep's segment loop (``_packed_segments``) against the
  reference's ``_collapsed_sweep_packed`` over two sweeps, on each sweep's
  draws, with fixed hyper-parameters: the same ``seg_log`` through a
  mid-sweep growth (8 -> 16 ...) and a shrink at the sweep boundary.
* Whole ``collapsed_sweep(backend="fast")`` chains, statistically, with
  ``k_live_buckets`` "on" and "off", against the reference's oracle
  chains (the fixture of tests/test_torch_collapsed_sweep.py).
* ``k_live_buckets`` from ``DriverConfig`` and the CLI reaches the
  ``SamplerSpec``, and the hybrid tail runs the same at either value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import _collapsed_row_inputs
from test_torch_collapsed import MISMATCH_BUDGET, _case, jax_draws
from test_torch_collapsed_sweep import (  # noqa: F401  (the fixture)
    BURN,
    SWEEPS,
    chains,
)

from repro.core.ibp import IBPHypers as JHypers
from repro.core.ibp import init_state as jax_init_state
from repro.core.ibp import math as jibm
from repro.core.ibp.collapsed import PACK_HEADROOM as J_HEADROOM
from repro.core.ibp.collapsed import _collapsed_sweep_packed, _packed_scan
from repro.data import cambridge_data
from repro.kernels.collapsed_row.fast import (
    collapsed_row_flip_fast as jax_flip_fast,
)
from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
from repro_torch.core.ibp import collapsed as tcoll
from repro_torch.core.ibp import collapsed_sweep
from repro_torch.core.ibp import hybrid as thy
from repro_torch.core.ibp import math as tibm
from repro_torch.core.ibp.convergence import mean_diff_z
from repro_torch.interop import state_from_reference
from repro_torch.kernels.collapsed_row import collapsed_row_flip_fast
from repro_torch.kernels.collapsed_scan import collapsed_scan
from repro_torch.launch import mcmc
from repro_torch.runtime import DriverConfig

torch.set_num_threads(1)

SX, SA = 0.5, 1.0


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("K,D,seed", [(8, 12, 0), (16, 36, 1), (5, 7, 2)])
def test_g_rank1_matches_reference_and_stays_symmetric(K, D, seed):
    rng = np.random.default_rng(seed)
    act = (rng.random(K) < 0.7).astype(np.float32)
    H = (rng.standard_normal((K, D)) * act[:, None]).astype(np.float32)
    G = H @ H.T
    a = (rng.standard_normal(K) * act).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    got = tibm.g_rank1(_t(G), _t(H), _t(a), _t(b)).numpy()
    want = np.asarray(jibm.g_rank1(*(jnp.asarray(x) for x in (G, H, a, b))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, got.T)  # bitwise symmetric
    Hn = H + np.outer(a, b)
    np.testing.assert_allclose(got, Hn @ Hn.T, rtol=1e-4, atol=1e-3)
    # padded slots stay exactly 0
    assert not got[act < 0.5].any() and not got[:, act < 0.5].any()


def test_bucket_policy_matches_reference():
    for K_max in (1, 4, 8, 9, 16, 24, 64, 128):
        buckets = tibm.live_buckets(K_max)
        assert buckets == jibm.live_buckets(K_max)
        for kp in range(K_max + 1):
            for headroom in (0, J_HEADROOM):
                assert tibm.pick_bucket(buckets, kp, headroom) == \
                    jibm.pick_bucket(buckets, kp, headroom)
    assert tcoll.PACK_HEADROOM == J_HEADROOM
    with pytest.raises(ValueError):
        tibm.live_buckets(0)


@pytest.mark.parametrize("K,B,n_live,seed", [
    (16, 8, 3, 0), (32, 16, 12, 1), (64, 32, 25, 2), (64, 8, 4, 3),
    (16, 16, 5, 4), (8, 8, 0, 5)])
def test_block_select_matches_reference(K, B, n_live, seed):
    rng = np.random.default_rng(seed)
    act = np.zeros(K, np.float32)
    act[rng.choice(K, size=n_live, replace=False)] = 1.0
    cols, min_out = tibm.block_select(_t(act), B)
    cw, mw = jibm.block_select(jnp.asarray(act), B)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(cw))
    assert int(min_out) == int(mw)


# ---------------------------------------------------------------- rss flip


@pytest.mark.parametrize("K,D,frac,seed", [
    (8, 36, 1.0, 0), (12, 64, 0.6, 1), (16, 36, 0.8, 2), (5, 20, 1.0, 3)])
@pytest.mark.parametrize("with_g", [False, True])
def test_flip_fast_matches_reference(K, D, frac, seed, with_g):
    args = _collapsed_row_inputs(K, D, seed=seed, frac_active=frac)
    H = args[1]
    G = (H @ H.T).astype(np.float32) if with_g else None
    kw = dict(G=None if G is None else _t(G))
    got = collapsed_row_flip_fast(*(_t(a) for a in args), **kw)
    want = jax_flip_fast(*(jnp.asarray(a) for a in args),
                         G=None if G is None else jnp.asarray(G))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    assert np.any(got[0].numpy() != args[3])  # some bit flipped


# ------------------------------------------------------------ segment scan


def _packed_case(seed, n_rows, K, live_cols):
    """Cambridge rows scaled by 2 (features well above sigma_x = 0.5, so
    births are taken) and Bernoulli(0.4) columns at ``live_cols``."""
    X, _, _ = cambridge_data(N=n_rows, sigma_n=0.4, seed=seed)
    X = (2.0 * X).astype(np.float32)
    rng = np.random.default_rng(seed)
    Z = np.zeros((n_rows, K), np.float32)
    for c in live_cols:
        Z[:, c] = rng.random(n_rows) < 0.4
    act = (Z.sum(0) > 0).astype(np.float32)
    return X, Z, act, (Z.T @ Z, Z.T @ X, Z.sum(0))


# (seed, rows, K_can, live columns, B, alpha, refresh): B - K+ free slots
# in the block; the first cases give the block only PACK_HEADROOM free
# slots and make births common, so the scan overflows
SEGMENTS = [
    (0, 200, 16, (0, 3, 5, 6), 8, 3.0, 16),
    (2, 200, 32, (0, 5, 20), 8, 200.0, 64),
    (3, 240, 32, (2, 4, 11, 12, 30), 16, 1.0, 8),
]


@pytest.mark.parametrize("case", SEGMENTS, ids=lambda c: f"seed{c[0]}")
@pytest.mark.parametrize("birth", ["gibbs", "mh"])
@pytest.mark.parametrize("flavor", ["fast", "pallas"])
def test_segment_scan_matches_reference(case, birth, flavor):
    seed, n_rows, K, live, B, alpha, refresh = case
    X, Z, act, stats = _packed_case(seed, n_rows, K, live)
    N = float(n_rows) if birth == "gibbs" else 4.0 * n_rows
    key = jax.random.key(500 + seed)
    out = _packed_scan(
        *(jnp.asarray(a) for a in (Z, act, *stats, X)), key,
        jnp.float32(alpha), jnp.float32(SX), jnp.float32(SA), 0,
        N=N, birth=birth, B=B, refresh_every=refresh,
        flip_flavor="packed" if flavor == "fast" else "pallas",
        u_chunk_rows=n_rows, carry_g=True)
    d = jax_draws(key, n_rows, K, alpha, N, birth=birth)
    tz = [_t(a) for a in (Z, act, *stats, X)]
    counts = collapsed_scan(
        *tz, d.u_logit, d.j_prop, d.log_u_acc, torch.tensor(SX),
        torch.tensor(SA), N=N, refresh_every=refresh, drift_tol=1e-2,
        gumbel=d.gumbel,
        alpha=torch.tensor(alpha) if birth == "gibbs" else None,
        flavor=flavor, B=B)
    Zg, act_g = tz[0].numpy(), tz[1].numpy()
    Zw, act_w = np.asarray(out[0]), np.asarray(out[1])
    mism = int(np.sum(Zg * act_g != Zw * act_w))
    assert mism <= MISMATCH_BUDGET, f"{mism} bits diverged"
    n_refresh, n_sat, ovf_row = counts.tolist()
    assert ovf_row == int(out[8])
    assert n_refresh == int(out[5]) and n_sat == int(out[6])
    # the carried statistics stay exact: integer sums of the scanned Z,
    # out-of-block columns 0
    if mism == 0:
        np.testing.assert_array_equal(tz[2].numpy(), np.asarray(out[2]))
        np.testing.assert_array_equal(tz[4].numpy(), np.asarray(out[4]))
    rows = n_rows if ovf_row < 0 else ovf_row
    Zm = np.concatenate([Zg[:rows], Z[rows:]]) * act_g
    np.testing.assert_array_equal(tz[2].numpy(), Zm.T @ Zm)
    np.testing.assert_array_equal(tz[4].numpy(), Zm.sum(0))
    if birth == "gibbs" and seed < 3:  # built to overflow
        assert ovf_row >= 0
    # the rows past the overflow are untouched
    np.testing.assert_array_equal(Zg[rows:], Z[rows:])


# ------------------------------------------------------- the packed sweep


def _sweep_state(seed, N, K, alpha, sx, singles, row0, scale):
    """A reference state on Cambridge data (scaled by ``scale``): Z empty
    but for ``singles`` singleton columns from row ``row0`` on (they die
    when their row is scanned), sigma_a = 1."""
    X, _, _ = cambridge_data(N=N, sigma_n=0.4, seed=3)
    X = (scale * X).astype(np.float32)
    st = jax_init_state(jax.random.key(seed), N, X.shape[1], K_max=K,
                        K_init=1, alpha=alpha)
    Z = np.zeros((N, K), np.float32)
    for c in range(singles):
        Z[row0 + 12 * c, c] = 1.0
    st = dataclasses.replace(
        st, Z=jnp.asarray(Z), active=jnp.asarray(
            (Z.sum(0) > 0).astype(np.float32)),
        sigma_x=jnp.float32(sx), sigma_a=jnp.float32(1.0))
    return X, st


def _port_sweep(st, X, backend, seg_log):
    """The port's packed sweep on the reference sweep's draws (its key
    chain: split(state.key, 5), the scan's chain from the second key),
    with fixed hyper-parameters: the segment loop, then the pruning."""
    N, K = st.Z.shape
    _, ksweep, _, _, _ = jax.random.split(st.key, 5)
    alpha = float(st.alpha)
    d = jax_draws(ksweep, N, K, alpha, float(N), birth="gibbs")
    Z, act = _t(st.Z), _t(st.active)
    Xt = _t(X)
    m, ZtZ, ZtX, _ = tcoll._sweep_stats(Z, act, Xt)
    tcoll._packed_segments(
        Z, act, ZtZ, ZtX, m, Xt, torch.tensor(float(st.sigma_x)),
        torch.tensor(float(st.sigma_a)), torch.tensor(alpha), d,
        int(act.sum()), backend=backend, refresh_every=64, seg_log=seg_log)
    act = act * (m > 0.5)
    return (Z * act[None, :]).numpy(), act.numpy()


# growth: K+ = 4 at bucket 8, births overflow the block mid-sweep;
# shrink: 12 singleton columns (bucket 16) die, the next sweep packs at 8
@pytest.mark.parametrize("name,kw", [
    ("growth", dict(seed=0, N=150, K=32, alpha=3.0, sx=0.9, singles=4,
                    row0=100, scale=2.0)),
    ("shrink", dict(seed=3, N=150, K=32, alpha=1.0, sx=0.6, singles=12,
                    row0=10, scale=1.0))])
@pytest.mark.parametrize("backend", ["fast", "pallas"])
def test_packed_sweep_seg_log_matches_reference(name, kw, backend):
    X, st = _sweep_state(**kw)
    hyp = JHypers(resample_alpha=False, resample_sigmas=False)
    logs_ref, logs_port = [], []
    for _ in range(2):
        seg_p = []
        Zp, act_p = _port_sweep(st, X, backend, seg_p)
        seg_r = []
        st = _collapsed_sweep_packed(st, jnp.asarray(X), hyp, backend, 64,
                                     seg_log=seg_r)
        logs_ref.append(seg_r)
        logs_port.append(seg_p)
        mism = int(np.sum(Zp != np.asarray(st.Z)))
        assert mism <= MISMATCH_BUDGET, f"{mism} bits diverged"
        np.testing.assert_array_equal(act_p, np.asarray(st.active))
    assert logs_port == [[tuple(s) for s in seg] for seg in logs_ref]
    first = [seg[0][0] for seg in logs_ref]
    if name == "growth":  # a mid-sweep repack to a larger bucket
        assert len(logs_ref[0]) > 1 and logs_ref[0][1][0] > first[0]
    else:  # the second sweep packs smaller than the first
        assert first[1] < first[0]


@pytest.mark.parametrize("k_live", ["on", "off"])
def test_fast_sweep_matches_reference_statistically(chains, k_live):
    X, starts, ref = chains
    Xt = torch.from_numpy(X)
    port = np.zeros_like(ref)
    for c, st_np in enumerate(starts):
        st = state_from_reference(st_np, device="cpu")
        for i in range(SWEEPS):
            st = collapsed_sweep(st, Xt, IBPHypers(), backend="fast",
                                 k_live_buckets=k_live)
            if i >= BURN:
                port[:, c, i - BURN] = (float(st.active.sum()),
                                        float(st.sigma_x), float(st.alpha))
    for name, p, r in zip(("K+", "sigma_x", "alpha"), port, ref):
        z = mean_diff_z(p, r)
        assert abs(z) < 4.0, (name, p.mean(), r.mean(), z)


# ------------------------------------------------------------ the tail knob


@pytest.mark.parametrize("seed", [0, 1])
def test_tail_fast_matches_reference(seed):
    """The tail's "fast" scan (rss flip, carried G) against the
    reference's tail under its default ``k_live_buckets="on"``
    (``_packed_scan`` at the full width with ``carry_g=True``)."""
    R, Z, act = _case(40 + seed, K=8)
    n_rows, K = Z.shape
    N_global, alpha = 4.0 * n_rows, 60.0
    stats = (Z.T @ Z, Z.T @ R, Z.sum(0))
    key = jax.random.key(700 + seed)
    out = _packed_scan(
        *(jnp.asarray(a) for a in (Z, act, *stats, R)), key,
        jnp.float32(alpha), jnp.float32(SX), jnp.float32(SA), 0,
        N=N_global, birth="mh", B=K, refresh_every=8, flip_flavor="packed",
        u_chunk_rows=n_rows, carry_g=True)
    d = jax_draws(key, n_rows, K, alpha, N_global)
    got = tcoll.collapsed_row_scan(
        *(_t(a) for a in (Z, act, *stats, R)), torch.tensor(SX),
        torch.tensor(SA), d, N=N_global, backend="fast", refresh_every=8)
    mism = int(np.sum(got[0].numpy() != np.asarray(out[0])))
    assert mism <= MISMATCH_BUDGET
    assert int(got[5]) == int(out[5]) and int(got[6]) == int(out[6])


def test_k_live_buckets_reaches_the_tail(monkeypatch, tmp_path):
    """``k_live_buckets`` reaches the spec from ``SamplerSpec``,
    ``DriverConfig`` and the CLI, and the hybrid tail, which the
    reference switches by it, runs the same at either value: the port's
    "fast" tail carries G at every width."""
    seen = []
    scan = thy.collapsed_row_scan

    def spy(*args, **kw):
        seen.append(kw["backend"])
        return scan(*args, **kw)

    monkeypatch.setattr(thy, "collapsed_row_scan", spy)
    X, _, _ = cambridge_data(N=24, sigma_n=0.4, seed=2)
    for backend in ("fast", "pallas"):
        outs = []
        for spec in (
                SamplerSpec(P=2, K_max=8, K_tail=4, L=1,
                            collapsed_backend=backend),
                DriverConfig(P=2, K_max=8, K_tail=4, L=1,
                             collapsed_backend=backend,
                             k_live_buckets="off").to_spec()):
            seen.clear()
            s = build_sampler(spec, IBPHypers(), X, device="cpu")
            gs, ss = s.step(*s.init())
            assert seen == [backend], (spec, seen)
            outs.append((ss.Z, ss.Z_tail, gs.A, gs.active))
        for a, b in zip(*outs):  # the knob changes nothing in the tail
            assert torch.equal(a, b), backend
    seen.clear()
    drv = mcmc.main(["--device", "cpu", "--N", "40", "--P", "2", "--iters",
                     "1", "--eval-every", "1", "--K-max", "8", "--K-tail",
                     "2", "--L", "1", "--k-live-buckets", "off",
                     "--ckpt-dir", str(tmp_path / "ck"),
                     "--out", str(tmp_path / "h.json")])
    assert drv.spec.k_live_buckets == "off" and seen == ["fast"]
    assert DriverConfig(k_live_buckets="off").to_spec().k_live_buckets \
        == "off"
    assert SamplerSpec().k_live_buckets == "on"
    with pytest.raises(ValueError, match="k_live_buckets"):
        SamplerSpec(k_live_buckets="maybe")
    with pytest.raises(ValueError, match="flavor"):
        collapsed_scan(*(torch.zeros(s) for s in ((2, 2), (2,), (2, 2),
                                                  (2, 3), (2,), (2, 3),
                                                  (2, 2), (2,), (2,))),
                       torch.tensor(1.0), torch.tensor(1.0), N=2.0,
                       refresh_every=4, drift_tol=1e-2, flavor="jnp")
