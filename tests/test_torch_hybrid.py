"""The port's hybrid iteration against the reference's.

* Carrying state across: ``interop.from_reference`` takes the reference's
  ``init_hybrid`` state field for field, and one port iteration from it
  (sigma and alpha resampling off) keeps the hyper-parameters, moves the
  bookkeeping, and draws A around the posterior mean that the reference's
  ``a_posterior`` gives on the same statistics (rtol 1e-5: the same
  float32 operations).
* The whole slice, statistically: JAX threefry and torch Philox streams
  differ, so the port (CPU, plain kernel versions) and the reference
  (default backends) are run as chains on the same data and their
  stationary mean K+ and sigma_x compared with the MCSE-aware z-score of
  ``convergence.mean_diff_z`` (|z| < 4, the tolerance of
  tests/test_exactness.py).
"""
import jax
import numpy as np
import torch

from repro.core.ibp import IBPHypers as JHypers
from repro.core.ibp import SamplerSpec as JSpec
from repro.core.ibp import build_sampler as jax_build_sampler
from repro.core.ibp import hybrid as jhy
from repro.core.ibp import math as jibm
from repro.data import cambridge_data
from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler, convergence
from repro_torch.core.ibp import hybrid as thy
from repro_torch.core.ibp import math as tibm
from repro_torch.interop import from_reference

torch.set_num_threads(1)


def _reference_state(P=2, K_max=16, K_tail=8, N=100, seed=0):
    X, _, _ = cambridge_data(N=N, sigma_n=0.5, seed=seed)
    Xs = X[: (N // P) * P].reshape(P, N // P, -1)
    gs, ss = jhy.init_hybrid(jax.random.key(seed), jax.numpy.asarray(Xs),
                             K_max, K_tail=K_tail)
    gs_np = {f: np.asarray(jax.random.key_data(v) if f == "key" else v)
             for f, v in vars(gs).items()}
    ss_np = {f: np.asarray(v) for f, v in vars(ss).items()}
    return Xs, gs_np, ss_np


def test_from_reference_carries_state_and_one_iteration_holds():
    Xs, gs_np, ss_np = _reference_state()
    gs, ss = from_reference(gs_np, ss_np, device="cpu")
    for f, v in gs_np.items():
        np.testing.assert_array_equal(getattr(gs, f).numpy(), v, err_msg=f)
    for f, v in ss_np.items():
        np.testing.assert_array_equal(getattr(ss, f).numpy(), v, err_msg=f)
    assert gs.key.dtype == torch.uint32 and gs.it.dtype == torch.int32

    hyp = IBPHypers(resample_sigmas=False, resample_alpha=False)
    X_t = torch.from_numpy(Xs)
    gs1, ss1 = thy._hybrid_iteration_body(X_t, gs, ss, hyp, L=2,
                                          N_g=float(Xs.shape[0] * Xs.shape[1]))
    for f in ("sigma_x", "sigma_a", "alpha"):
        assert float(getattr(gs1, f)) == float(getattr(gs, f)), f
    assert int(gs1.it) == 1 and 0 <= int(gs1.p_prime) < Xs.shape[0]
    assert not torch.equal(gs1.key, gs.key)
    assert float(ss1.tail_active.abs().sum()) == 0.0  # tails cleared
    act = gs1.active.numpy()
    Z = ss1.Z.numpy()
    assert np.all(Z[..., act < 0.5] == 0)
    assert 1 <= act.sum() <= 16

    # the A draw sits around the posterior mean of the same statistics
    Zf = Z.reshape(-1, Z.shape[-1])
    Xf = Xs.reshape(-1, Xs.shape[-1])
    ZtZ = (Zf.T @ Zf) * np.outer(act, act)
    ZtX = (Zf.T @ Xf) * act[:, None]
    sx, sa = np.float32(gs.sigma_x), np.float32(gs.sigma_a)
    mean_j, M_j = (np.asarray(a) for a in jibm.a_posterior(
        jax.numpy.asarray(ZtZ), jax.numpy.asarray(ZtX),
        jax.numpy.asarray(act), sx, sa))
    mean_t, _ = tibm.a_posterior(torch.from_numpy(ZtZ), torch.from_numpy(ZtX),
                                 torch.from_numpy(act), gs.sigma_x, gs.sigma_a)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, rtol=1e-5, atol=1e-5)
    A = gs1.A.numpy()
    live = act > 0.5
    assert np.all(A[~live] == 0)
    zs = (A - mean_j)[live] / (sx * np.sqrt(np.diag(M_j))[live, None])
    assert np.all(np.abs(zs) < 6.0), np.abs(zs).max()


def _traces(step, gs, st, burn, T):
    K, S = [], []
    for i in range(burn + T):
        gs, st = step(gs, st)
        if i >= burn:
            K.append(float(gs.active.sum()))
            S.append(float(gs.sigma_x))
    return np.array(K), np.array(S)


def test_whole_slice_matches_reference_statistically():
    X, _, _ = cambridge_data(N=100, sigma_n=0.5, seed=1)
    burn, T = 50, 250
    js = jax_build_sampler(JSpec(P=2, K_max=16, L=2), JHypers(), X)
    gs, st = js.init(jax.random.key(0))
    K_j, S_j = _traces(js.step, gs, st, burn, T)
    ts = build_sampler(SamplerSpec(P=2, K_max=16, L=2), IBPHypers(), X,
                       device="cpu")
    gs, st = ts.init()
    K_t, S_t = _traces(ts.step, gs, st, burn, T)
    assert np.all((K_t >= 1) & (K_t <= 16)) and np.all(np.isfinite(S_t))
    for name, a, b in (("K+", K_t, K_j), ("sigma_x", S_t, S_j)):
        z = convergence.mean_diff_z(a, b)
        assert abs(z) < 4.0, (name, a.mean(), b.mean(), z)
