"""The port's serial collapsed sampler against the reference's.

* The carried scan with Gibbs births (the plain version of the
  ``collapsed_scan`` kernel) against the reference's ``_packed_scan(birth=
  "gibbs", B=K, carry_g=False, flip_flavor="jnp")``, and the O(K^3)
  oracle ``_row_step`` (``backend="ref"``) against the reference's
  ``collapsed_row_scan(backend="ref")`` with Gibbs and with MH births.
  Both packages get the same numpy inputs and the port is fed the draws
  the reference's key chain makes (``jax_draws``: the flip uniforms and,
  for Gibbs births, the Gumbel noise ``jax.random.categorical`` adds to
  the logits). Decisions may differ only at float-boundary events (the
  reference's float32 lgamma is off log j! by up to 1e-6, the port uses
  the rounded table): at most MISMATCH_BUDGET Z bits per run, equal
  refresh and saturation counts, the carried ZᵀZ and m exact against
  the final Z.
* Whole ``collapsed_sweep`` chains, statistically (JAX threefry and torch
  Philox streams differ): four chains of each package from the same four
  states on Cambridge data (N=40, K_max=10), 45 sweeps, the first 15
  burned; the stationary means of K+, sigma_x and alpha agree within
  |z| < 4 of ``convergence.mean_diff_z`` (MCSE across chains), for the
  port's ``"pallas"`` and ``"ref"`` backends.
* The knobs: ``k_live_buckets="on"`` runs for both carried backends,
  what the reference rejects raises ``ValueError``, and the hybrid
  sampler steps with ``collapsed_backend="ref"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_collapsed import MISMATCH_BUDGET, jax_draws

from repro.core.ibp import IBPHypers as JHypers
from repro.core.ibp import collapsed_sweep as jax_collapsed_sweep
from repro.core.ibp import init_state as jax_init_state
from repro.core.ibp.collapsed import _packed_scan
from repro.core.ibp.collapsed import collapsed_row_scan as jax_row_scan
from repro.data import cambridge_data
from repro_torch.core.ibp import (
    IBPHypers,
    SamplerSpec,
    build_sampler,
    collapsed_sweep,
)
from repro_torch.core.ibp.collapsed import collapsed_row_scan, draw_scan
from repro_torch.core.ibp.convergence import mean_diff_z
from repro_torch.interop import state_from_reference
from repro_torch.runtime import DriverConfig

torch.set_num_threads(1)

SX, SA = 0.5, 1.0


def _sweep_case(seed, n_rows, K, k_live):
    """Cambridge rows (4 features of 6x6, sigma_n 0.4) scaled by 2 and a Z
    whose first ``k_live`` columns are Bernoulli(0.4): the data's features
    are not in Z and stand well above the scan's sigma_x, so births are
    taken and then shared by later rows."""
    X, _, _ = cambridge_data(N=n_rows, sigma_n=0.4, seed=seed)
    X = 2.0 * X
    rng = np.random.default_rng(seed)
    Z = np.zeros((n_rows, K), np.float32)
    Z[:, :k_live] = rng.random((n_rows, k_live)) < 0.4
    act = (Z.sum(0) > 0).astype(np.float32)
    return X.astype(np.float32), Z, act, (Z.T @ Z, Z.T @ X, Z.sum(0))


def _check(got, Zw, act_w, Z_in, tag):
    """Decisions within budget, births taken, carried stats exact."""
    Zg, act_g = got[0].numpy(), got[1].numpy()
    mism = int(np.sum(Zg * act_g != Zw * act_w))
    assert mism <= MISMATCH_BUDGET, f"{mism} bits diverged ({tag})"
    assert np.sum(Zw != Z_in) > 0  # the scan moved: flips and births
    Zm = Zg * act_g
    np.testing.assert_array_equal(got[2].numpy(), Zm.T @ Zm)
    np.testing.assert_array_equal(got[4].numpy(), Zm.sum(0))


# 600 rows: the reference refills its uniforms in chunks of 512; alpha =
# N/4 makes births common, and at K=5 the free capacity binds
@pytest.mark.parametrize("seed,n_rows,K,refresh,alpha", [
    (0, 60, 8, 64, 3.0), (1, 80, 10, 8, 3.0), (2, 600, 8, 64, 3.0),
    (3, 60, 5, 16, 15.0)])
def test_gibbs_scan_matches_reference(seed, n_rows, K, refresh, alpha):
    X, Z, act, stats = _sweep_case(seed, n_rows, K, k_live=2)
    N = float(n_rows)
    key = jax.random.key(200 + seed)
    out = _packed_scan(
        *(jnp.asarray(a) for a in (Z, act, *stats, X)), key,
        jnp.float32(alpha), jnp.float32(SX), jnp.float32(SA), 0,
        N=N, birth="gibbs", B=K, refresh_every=refresh, flip_flavor="jnp",
        carry_g=False)
    draws = jax_draws(key, n_rows, K, alpha, N, birth="gibbs")
    tz = [torch.from_numpy(np.asarray(a)) for a in (Z, act, *stats, X)]
    got = collapsed_row_scan(*tz, torch.tensor(SX), torch.tensor(SA), draws,
                             N=N, alpha=torch.tensor(alpha), birth="gibbs",
                             refresh_every=refresh)
    _check(got, np.asarray(out[0]), np.asarray(out[1]), Z, f"seed={seed}")
    assert int(got[5]) == int(out[5])  # refreshes (cadence + monitor)
    assert int(got[6]) == int(out[6]) == 0  # no saturation in Gibbs mode


@pytest.mark.parametrize("birth,seed,alpha,N_mult", [
    ("gibbs", 4, 3.0, 1.0), ("gibbs", 5, 15.0, 1.0), ("mh", 6, 3.0, 4.0),
    ("mh", 7, 60.0, 1.0)])
def test_oracle_row_step_matches_reference(birth, seed, alpha, N_mult):
    n_rows, K = 50, 6
    X, Z, act, stats = _sweep_case(seed, n_rows, K, k_live=2)
    N = N_mult * n_rows
    key = jax.random.key(300 + seed)
    out = jax_row_scan(*(jnp.asarray(a) for a in (Z, act, *stats, X)), key,
                       jnp.float32(alpha), jnp.float32(SX), jnp.float32(SA),
                       N=N, birth=birth, backend="ref")
    draws = jax_draws(key, n_rows, K, alpha, N, birth=birth)
    tz = [torch.from_numpy(np.asarray(a)) for a in (Z, act, *stats, X)]
    got = collapsed_row_scan(*tz, torch.tensor(SX), torch.tensor(SA), draws,
                             N=N, alpha=torch.tensor(alpha), birth=birth,
                             backend="ref")
    _check(got, np.asarray(out[0]), np.asarray(out[1]), Z,
           f"{birth} seed={seed}")
    assert int(got[5]) == int(out[5]) == 0  # the oracle never refreshes
    assert int(got[6]) == int(out[6])  # capacity-vetoed MH births


def _np_fields(st) -> dict:
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = np.asarray(jax.random.key_data(v) if f.name == "key"
                                 else v)
    return out


CHAINS, SWEEPS, BURN = 4, 45, 15


@pytest.fixture(scope="module")
def chains():
    """The data, the four start states (K_init = 1..4), and the reference's
    traces of K+, sigma_x and alpha from them (``backend="ref"``, the
    jitted oracle)."""
    X, _, _ = cambridge_data(N=40, sigma_n=0.4, seed=3)
    starts = [jax_init_state(jax.random.key(c), X.shape[0], X.shape[1],
                             K_max=10, K_init=c + 1) for c in range(CHAINS)]
    Xj = jnp.asarray(X)
    ref = np.zeros((3, CHAINS, SWEEPS - BURN))
    for c, st in enumerate(starts):
        for i in range(SWEEPS):
            st = jax_collapsed_sweep(st, Xj, JHypers(), backend="ref")
            if i >= BURN:
                ref[:, c, i - BURN] = (float(st.active.sum()),
                                       float(st.sigma_x), float(st.alpha))
    return X, [_np_fields(s) for s in starts], ref


@pytest.mark.parametrize("backend", ["pallas", "ref"])
def test_collapsed_sweep_matches_reference_statistically(chains, backend):
    X, starts, ref = chains
    Xt = torch.from_numpy(X)
    port = np.zeros_like(ref)
    for c, st_np in enumerate(starts):
        st = state_from_reference(st_np, device="cpu")
        for i in range(SWEEPS):
            st = collapsed_sweep(st, Xt, IBPHypers(), backend=backend)
            if i >= BURN:
                port[:, c, i - BURN] = (float(st.active.sum()),
                                        float(st.sigma_x), float(st.alpha))
    for name, p, r in zip(("K+", "sigma_x", "alpha"), port, ref):
        z = mean_diff_z(p, r)
        assert abs(z) < 4.0, (name, p.mean(), r.mean(), z)
    assert 2.0 <= port[0].mean() <= 9.0  # Cambridge data has 4 features
    assert 0.3 <= port[1].mean() <= 0.6  # its noise sigma is 0.4


def test_collapsed_sweep_layout_and_keys():
    X, _, _ = cambridge_data(N=30, sigma_n=0.4, seed=1)
    st = state_from_reference(_np_fields(jax_init_state(
        jax.random.key(1), 30, 36, K_max=8, K_init=2)), device="cpu")
    nxt = collapsed_sweep(st, torch.from_numpy(X), IBPHypers())
    assert int(nxt.it) == 1 and nxt.key.device.type == "cpu"
    assert nxt.Z.shape == st.Z.shape and nxt.A is st.A and nxt.pi is st.pi
    Z, act = nxt.Z.numpy(), nxt.active.numpy()
    assert set(np.unique(Z)) <= {0.0, 1.0}
    assert not Z[:, act < 0.5].any() and (Z[:, act > 0.5].sum(0) > 0).all()
    fixed = collapsed_sweep(st, torch.from_numpy(X), IBPHypers(
        resample_sigmas=False, resample_alpha=False))
    for k in ("sigma_x", "sigma_a", "alpha"):
        assert float(getattr(fixed, k)) == float(getattr(st, k)), k
    # one stream per sweep: the same state and data repeat the sweep
    again = collapsed_sweep(st, torch.from_numpy(X), IBPHypers())
    np.testing.assert_array_equal(again.Z.numpy(), Z)


def test_knobs_not_ported_or_rejected():
    X, _, _ = cambridge_data(N=20, sigma_n=0.4, seed=0)
    st = state_from_reference(_np_fields(jax_init_state(
        jax.random.key(0), 20, 36, K_max=4, K_init=1)), device="cpu")
    Xt = torch.from_numpy(X)
    for backend in ("pallas", "fast"):  # the packed carry is ported
        assert int(collapsed_sweep(st, Xt, IBPHypers(), backend=backend,
                                   k_live_buckets="on").it) == 1
    for kw in (dict(backend="bogus"), dict(k_live_buckets="maybe")):
        with pytest.raises(ValueError):
            collapsed_sweep(st, Xt, IBPHypers(), **kw)
    with pytest.raises(ValueError):
        draw_scan(4, 4, st.alpha, 20.0, torch.Generator(), birth="bogus")
    # "ref" has no carry and ignores the knob, as in the reference
    assert int(collapsed_sweep(st, Xt, IBPHypers(), backend="ref",
                               k_live_buckets="on").it) == 1
    with pytest.raises(ValueError, match="SamplerSpec"):
        SamplerSpec(collapsed_backend="bogus")


def test_hybrid_steps_with_the_oracle_tail():
    X, _, _ = cambridge_data(N=48, sigma_n=0.4, seed=2)
    spec = DriverConfig(P=2, K_max=8, K_tail=4, L=2,
                        collapsed_backend="ref").to_spec()
    assert spec.collapsed_backend == "ref"
    s = build_sampler(spec, IBPHypers(), X, device="cpu")
    gs, ss = s.init()
    for _ in range(3):
        gs, ss = s.step(gs, ss)
    assert int(gs.it) == 3 and np.isfinite(float(gs.sigma_x))
    assert 1 <= int(gs.active.sum()) <= 8
    # the oracle and the carried tail make the same decisions on the same
    # draws: one iteration from the same state agrees
    fast = build_sampler(spec.replace(collapsed_backend="fast"), IBPHypers(),
                         X, device="cpu")
    a, b = s.step(gs, ss), fast.step(gs, ss)
    assert int(np.sum(a[1].Z.numpy() != b[1].Z.numpy())) <= MISMATCH_BUDGET
