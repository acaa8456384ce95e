"""The port's serial uncollapsed baseline against the reference's.

* Parts, on the same numpy inputs: ``sufficient_stats`` (m and ZtZ
  exact, ZtX and trXtX at rtol 1e-5, atol 1e-4 for summation order),
  ``match_features`` equal, ``init_state``'s layout,
  ``interop.state_from_reference``.
* The whole step, statistically (JAX threefry and torch Philox streams
  differ): four chains of each package from the same four states on
  Cambridge data (N=120, K=8 all active), 150 steps, the first 50
  burned; the stationary sigma_x means agree within |z| < 4 of
  ``convergence.mean_diff_z``, whose MCSE counts the spread between
  chains (one chain each under-counts it: this sampler sticks to modes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import SHAPES, _inputs

from repro.core.ibp import IBPHypers as JHypers
from repro.core.ibp import init_state as jax_init_state
from repro.core.ibp import sufficient_stats as jax_sufficient_stats
from repro.core.ibp import uncollapsed_step as jax_uncollapsed_step
from repro.core.ibp.diagnostics import match_features as jax_match_features
from repro.data import cambridge_data
from repro_torch import prng
from repro_torch.core.ibp import (
    IBPHypers,
    IBPState,
    init_state,
    sufficient_stats,
    uncollapsed_step,
)
from repro_torch.core.ibp.convergence import mean_diff_z
from repro_torch.core.ibp.diagnostics import match_features
from repro_torch.interop import state_from_reference

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    X, _, Atrue = cambridge_data(N=120, sigma_n=0.4, seed=3)
    return X, Atrue


def _np_fields(st) -> dict:
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name == "key":
            v = jax.random.key_data(v)
        out[f.name] = np.asarray(v)
    return out


def _seeded_reference_state(X, seed: int, K: int = 8):
    """The reference's init_state with A seeded from the first K data rows,
    as tests/test_samplers.py::test_uncollapsed_fits_with_fixed_truncation
    does."""
    st = jax_init_state(jax.random.key(seed), X.shape[0], X.shape[1],
                        K_max=K, K_init=K)
    return dataclasses.replace(st, A=jnp.asarray(X[:K]) + 0.01)


@pytest.mark.parametrize("N,D,K", SHAPES)
def test_sufficient_stats_matches_reference(N, D, K):
    X, Z, _, _, _ = _inputs(N, D, K, seed=N + K)
    want = [np.asarray(a) for a in jax_sufficient_stats(jnp.asarray(X),
                                                        jnp.asarray(Z))]
    got = [t.numpy() for t in sufficient_stats(torch.from_numpy(X),
                                               torch.from_numpy(Z))]
    for name, g, w in zip(("m", "ZtZ", "ZtX", "trXtX"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        if name in ("m", "ZtZ"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("n_est,n_true", [(6, 4), (4, 4), (2, 4)])
def test_match_features_matches_reference(n_est, n_true):
    rng = np.random.default_rng(n_est)
    A_true = rng.standard_normal((n_true, 36))
    A_est = np.concatenate([A_true[::-1], rng.standard_normal((4, 36))])
    A_est = A_est[:n_est] + 0.1 * rng.standard_normal((n_est, 36))
    got, sse = match_features(A_est.astype(np.float32), A_true)
    want, want_sse = jax_match_features(A_est.astype(np.float32), A_true)
    np.testing.assert_array_equal(got, want)
    assert sse == want_sse


@pytest.mark.parametrize("K_init", [0, 1, 3, 8])
def test_init_state_layout(K_init):
    N, D, K = 20, 6, 8
    st = init_state(prng.key(4), N, D, K, alpha=2.0, sigma_x=0.5,
                    sigma_a=1.5, K_init=K_init, device="cpu")
    ref = jax_init_state(jax.random.key(4), N, D, K, alpha=2.0, sigma_x=0.5,
                         sigma_a=1.5, K_init=K_init)
    want = _np_fields(ref)
    for f in dataclasses.fields(IBPState):
        t = getattr(st, f.name)
        assert tuple(t.shape) == want[f.name].shape, f.name
        assert t.numpy().dtype == want[f.name].dtype, f.name
        assert t.device.type == "cpu", f.name
    for k in ("active", "pi", "tail", "alpha", "sigma_x", "sigma_a",
              "p_prime", "it"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), want[k],
                                      err_msg=k)
    Z, A = st.Z.numpy(), st.A.numpy()
    assert set(np.unique(Z)) <= {0.0, 1.0}
    assert not Z[:, K_init:].any() and not A[K_init:].any()
    if K_init:
        assert 0 < Z[:, :K_init].mean() < 1 and (A[:K_init] != 0).all()
    assert int(st.k_plus) == K_init and st.k_max == K
    np.testing.assert_array_equal(st.key.numpy(),
                                  prng.split(prng.key(4), 3)[2].numpy())
    again = init_state(prng.key(4), N, D, K, K_init=K_init, sigma_a=1.5,
                       device="cpu")
    np.testing.assert_array_equal(again.Z.numpy(), Z)
    np.testing.assert_array_equal(again.A.numpy(), A)


def test_state_from_reference_round_trip(data):
    X, _ = data
    ref = _seeded_reference_state(X, seed=7)
    want = _np_fields(ref)
    st = state_from_reference(want, device="cpu")
    assert isinstance(st, IBPState)
    for k, w in want.items():
        got = getattr(st, k).numpy()
        assert got.dtype == (np.uint32 if k == "key" else w.dtype), k
        np.testing.assert_array_equal(got, w, err_msg=k)
    assert st.key.device.type == st.it.device.type == "cpu"
    assert int(st.k_plus) == int(ref.k_plus) and st.k_max == ref.k_max


def test_uncollapsed_step_keeps_the_finite_model_layout(data):
    X, _ = data
    st = state_from_reference(_np_fields(_seeded_reference_state(X, 1)),
                              device="cpu")
    nxt = uncollapsed_step(st, torch.from_numpy(X), IBPHypers())
    assert int(nxt.it) == 1 and nxt.Z.shape == st.Z.shape
    np.testing.assert_array_equal(nxt.key.numpy(),
                                  prng.split(st.key, 7)[0].numpy())
    np.testing.assert_array_equal(nxt.active.numpy(), np.ones(8, np.float32))
    assert set(np.unique(nxt.Z.numpy())) <= {0.0, 1.0}
    pi = nxt.pi.numpy()
    assert ((pi > 0) & (pi < 1)).all()
    for k in ("sigma_x", "sigma_a", "alpha"):
        assert np.isfinite(float(getattr(nxt, k))) and \
            float(getattr(nxt, k)) > 0, k
    fixed = uncollapsed_step(st, torch.from_numpy(X),
                             IBPHypers(resample_sigmas=False,
                                       resample_alpha=False))
    for k in ("sigma_x", "sigma_a", "alpha"):
        assert float(getattr(fixed, k)) == float(getattr(st, k)), k


def test_uncollapsed_matches_reference_statistically(data):
    X, _ = data
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    C, T, burn = 4, 150, 50
    sx_ref, sx_port = np.zeros((C, T - burn)), np.zeros((C, T - burn))
    for c in range(C):
        st = _seeded_reference_state(X, seed=c)
        pst = state_from_reference(_np_fields(st), device="cpu")
        for i in range(T):
            st = jax_uncollapsed_step(st, Xj, JHypers())
            pst = uncollapsed_step(pst, Xt, IBPHypers())
            if i >= burn:
                sx_ref[c, i - burn] = float(st.sigma_x)
                sx_port[c, i - burn] = float(pst.sigma_x)
    z = mean_diff_z(sx_port, sx_ref)
    assert abs(z) < 4.0, (sx_port.mean(), sx_ref.mean(), z)
    assert 0.3 <= sx_port.mean() <= 0.5


def test_uncollapsed_fits_with_fixed_truncation(data):
    """The port's run of tests/test_samplers.py::
    test_uncollapsed_fits_with_fixed_truncation."""
    X, _ = data
    st = init_state(prng.key(2), X.shape[0], 36, K_max=8, K_init=8,
                    device="cpu")
    st = dataclasses.replace(st, A=torch.from_numpy(X[:8]) + 0.01)
    Xt = torch.from_numpy(X)
    for _ in range(60):
        st = uncollapsed_step(st, Xt, IBPHypers())
    assert 0.25 <= float(st.sigma_x) <= 0.7
