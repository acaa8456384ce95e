"""The port's IBP math and master-sync pieces against the reference's.

Cases follow tests/test_ibp_math.py. Both packages get the same numpy
inputs. The rank-one Cholesky moves and the posterior are float32 paths
of identical operations, compared at rtol 1e-5 (and against a fresh
float64 factorization at the reference tests' 2e-4); the untransposed
moves and the Sherman-Morrison moves at atol 1e-5 (LAPACK and XLA solve
in their own order); ``collapsed_loglik`` at rtol 1e-5 (a float32 sum of
terms of either sign); promote_tail is integer bookkeeping and must
agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ibp import hybrid as jhy
from repro.core.ibp import math as jibm
from repro_torch import prng
from repro_torch.core.ibp import hybrid as thy
from repro_torch.core.ibp import math as tibm

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _padded_chol_case(n, k_max, k_act, seed):
    rng = np.random.default_rng(seed)
    act = np.zeros(k_max, np.float32)
    act[np.sort(rng.choice(k_max, size=k_act, replace=False))] = 1.0
    Zcols = (rng.random((n, k_max)) < 0.5).astype(np.float64) * act
    W = Zcols.T @ Zcols + 0.7 * np.diag(act) + np.diag(1.0 - act)
    x = (rng.random(k_max) < 0.5).astype(np.float64) * act
    return W, x, act


@pytest.mark.parametrize("n,k_max,seed", [(8, 2, 0), (30, 12, 1), (60, 24, 2),
                                          (20, 7, 3), (45, 16, 4)])
def test_chol_rank1_moves_match_reference(n, k_max, seed):
    import scipy.linalg as sla

    rng = np.random.default_rng(seed)
    W, x, act = _padded_chol_case(n, k_max, int(rng.integers(1, k_max + 1)),
                                  seed)
    L = np.linalg.cholesky(W).astype(np.float32)
    p = sla.solve_triangular(L, x, lower=True).astype(np.float32)
    Lt = np.ascontiguousarray(L.T)
    up_t = tibm.chol_rank1_update_t(_t(Lt), _t(p)).numpy()
    up_j = np.asarray(jibm.chol_rank1_update_t(jnp.asarray(Lt), jnp.asarray(p)))
    np.testing.assert_allclose(up_t, up_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(up_t.T, np.linalg.cholesky(W + np.outer(x, x)),
                               rtol=2e-4, atol=2e-4)
    # padding transparency: inactive rows/cols stay exactly identity
    inact = act < 0.5
    assert np.all(up_t[inact][:, ~inact] == 0)
    assert np.all(up_t[np.ix_(inact, inact)] == np.eye(int(inact.sum())))
    # downdate back from the updated factor
    Lu = np.linalg.cholesky(W + np.outer(x, x)).astype(np.float32)
    pu = sla.solve_triangular(Lu, x, lower=True).astype(np.float32)
    dn_t, ok_t = tibm.chol_rank1_downdate_t(_t(np.ascontiguousarray(Lu.T)),
                                            _t(pu))
    dn_j, ok_j = jibm.chol_rank1_downdate_t(jnp.asarray(Lu.T), jnp.asarray(pu))
    assert bool(ok_t) and bool(ok_j)
    np.testing.assert_allclose(dn_t.numpy(), np.asarray(dn_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dn_t.numpy().T, np.linalg.cholesky(W),
                               rtol=2e-4, atol=2e-4)


def test_chol_rank1_downdate_canary_fires_on_pd_loss():
    K = 6
    L = np.linalg.cholesky(0.1 * np.eye(K)).astype(np.float32)
    p = np.linalg.solve(L, np.ones(K)).astype(np.float32)
    _, ok = tibm.chol_rank1_downdate_t(_t(L.T.copy()), _t(p))
    assert not bool(ok)


def test_padded_W_chol_inv_and_a_posterior_match_reference():
    rng = np.random.default_rng(1)
    N, D, K, K_max = 40, 6, 3, 8
    Z = (rng.random((N, K)) < 0.5).astype(np.float64)
    X = Z @ rng.standard_normal((K, D)) + 0.2 * rng.standard_normal((N, D))
    Zp = np.zeros((N, K_max), np.float32)
    Zp[:, :K] = Z
    act = np.zeros(K_max, np.float32)
    act[:K] = 1
    ZtZ, ZtX = Zp.T @ Zp, (Zp.T @ X).astype(np.float32)
    ratio = np.float32(0.4**2)
    np.testing.assert_array_equal(
        tibm.padded_W(_t(ZtZ), _t(act), torch.tensor(ratio)).numpy(),
        np.asarray(jibm.padded_W(jnp.asarray(ZtZ), jnp.asarray(act), ratio)))
    W = np.asarray(jibm.padded_W(jnp.asarray(ZtZ), jnp.asarray(act), ratio))
    L_t, M_t = tibm.chol_inv(_t(W))
    L_j, M_j = jibm.chol_inv(jnp.asarray(W))
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=1e-5,
                               atol=1e-6)
    _, ld_t = tibm.chol_inv_logdet(_t(W))
    _, ld_j = jibm.chol_inv_logdet(jnp.asarray(W))
    np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=1e-5)

    sx, sa = np.float32(0.4), np.float32(1.0)
    mean_t, Mp_t = tibm.a_posterior(_t(ZtZ), _t(ZtX), _t(act),
                                    torch.tensor(sx), torch.tensor(sa))
    mean_j, Mp_j = jibm.a_posterior(jnp.asarray(ZtZ), jnp.asarray(ZtX),
                                    jnp.asarray(act), sx, sa)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(Mp_t.numpy(), np.asarray(Mp_j), rtol=1e-5,
                               atol=1e-6)
    # against the conjugate formula, and inactive rows exactly zero
    W64 = Z.T @ Z + (0.4 / 1.0) ** 2 * np.eye(K)
    np.testing.assert_allclose(mean_t.numpy()[:K],
                               np.linalg.solve(W64, Z.T @ X), rtol=1e-3,
                               atol=1e-4)
    assert np.all(mean_t.numpy()[K:] == 0)


def test_a_posterior_draw_moments_and_generator():
    rng = np.random.default_rng(2)
    N, D, K, K_max = 60, 4, 2, 4
    Z = (rng.random((N, K)) < 0.6).astype(np.float64)
    X = Z @ rng.standard_normal((K, D)) + 0.3 * rng.standard_normal((N, D))
    Zp = np.zeros((N, K_max), np.float32)
    Zp[:, :K] = Z
    act = np.zeros(K_max, np.float32)
    act[:K] = 1
    args = (_t(Zp.T @ Zp), _t(Zp.T @ X), _t(act), torch.tensor(0.5),
            torch.tensor(1.0))
    draws = np.stack([tibm.a_posterior_draw(
        prng.generator(prng.key(i), "cpu"), *args).numpy()[:K]
        for i in range(400)])
    W = Z.T @ Z + 0.25 * np.eye(K)
    M = np.linalg.inv(W)
    np.testing.assert_allclose(draws.mean(0), M @ Z.T @ X, atol=0.05)
    np.testing.assert_allclose(draws.var(0).mean(axis=1), 0.25 * np.diag(M),
                               rtol=0.35)
    g = lambda: prng.generator(prng.key(7), "cpu")  # noqa: E731
    np.testing.assert_array_equal(tibm.a_posterior_draw(g(), *args).numpy(),
                                  tibm.a_posterior_draw(g(), *args).numpy())


def test_gamma_family_draw_moments():
    g = prng.generator(prng.key(0), "cpu")
    a, b = 5.0, 3.0
    ig = tibm.inverse_gamma_draw(g, torch.full((4000,), a), b)
    assert np.isclose(float(ig.mean()), b / (a - 1), rtol=0.1)
    ga = tibm.gamma_draw(g, torch.full((4000,), a), b)
    assert np.isclose(float(ga.mean()), a / b, rtol=0.05)
    be = tibm.beta_draw(g, torch.full((4000,), 2.0), torch.full((4000,), 6.0))
    assert np.isclose(float(be.mean()), 0.25, rtol=0.05)


def test_harmonic_and_loglik_helpers_match_reference():
    for n in (1, 7, 1000):
        assert tibm.harmonic(n) == jibm.harmonic(n)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((20, 6)).astype(np.float32)
    Z = (rng.random((20, 5)) < 0.4).astype(np.float32)
    A = rng.standard_normal((5, 6)).astype(np.float32)
    pi = rng.random(5).astype(np.float32)
    act = np.array([1, 1, 0, 1, 0], np.float32)
    np.testing.assert_allclose(
        float(tibm.uncollapsed_loglik(_t(X), _t(Z), _t(A), torch.tensor(0.7))),
        float(jibm.uncollapsed_loglik(jnp.asarray(X), jnp.asarray(Z),
                                      jnp.asarray(A), jnp.float32(0.7))),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tibm.z_prior_loglik(_t(Z), _t(pi), _t(act))),
        float(jibm.z_prior_loglik(jnp.asarray(Z), jnp.asarray(pi),
                                  jnp.asarray(act))), rtol=1e-5)


@pytest.mark.parametrize("n_active,tail", [
    (3, [1, 0, 1, 1, 0, 0]),       # room for every tail column
    (7, [1, 1, 0, 1, 0, 1]),       # 3 free slots, 4 tails: one dropped
    (10, [0, 0, 0, 0, 0, 0]),      # nothing to promote
    (0, [1, 1, 1, 1, 1, 1]),       # empty model
])
def test_promote_tail_matches_reference(n_active, tail):
    rng = np.random.default_rng(n_active)
    P, N_p, K_max, K_tail = 3, 5, 10, 6
    active = np.zeros(K_max, np.float32)
    active[np.sort(rng.choice(K_max, n_active, replace=False))] = 1.0
    Z = ((rng.random((P, N_p, K_max)) < 0.5) * active).astype(np.float32)
    ta = np.array(tail, np.float32)
    Zt = np.zeros((P, N_p, K_tail), np.float32)
    Zt[1] = (rng.random((N_p, K_tail)) < 0.6) * ta  # shard p' = 1
    import jax
    Zj, aj, dj = jax.vmap(jhy.promote_tail, in_axes=(0, 0, None, None))(
        jnp.asarray(Z), jnp.asarray(Zt), jnp.asarray(ta), jnp.asarray(active))
    Zg, ag, dg = thy.promote_tail(_t(Z), _t(Zt), _t(ta), _t(active))
    np.testing.assert_array_equal(Zg.numpy(), np.asarray(Zj))
    np.testing.assert_array_equal(ag.numpy(), np.asarray(aj)[0])
    assert int(dg) == int(np.asarray(dj)[0])


@pytest.mark.parametrize("P,N_p,D,K", [(2, 16, 8, 4), (4, 33, 20, 16),
                                       (3, 50, 36, 32)])
def test_local_stats_and_sse_match_reference(P, N_p, D, K):
    import jax
    rng = np.random.default_rng(P + K)
    X = rng.standard_normal((P, N_p, D)).astype(np.float32)
    Z = (rng.random((P, N_p, K)) < 0.3).astype(np.float32)
    A = rng.standard_normal((K, D)).astype(np.float32)
    act = (rng.random(K) < 0.7).astype(np.float32)
    sj = jax.vmap(jhy.local_stats)(jnp.asarray(X), jnp.asarray(Z))
    sj = {k: np.asarray(v).sum(0) for k, v in sj.items()}
    st = thy.local_stats(_t(X), _t(Z))
    np.testing.assert_array_equal(st["m"].numpy(), sj["m"])
    np.testing.assert_array_equal(st["ZtZ"].numpy(), sj["ZtZ"])
    np.testing.assert_allclose(st["ZtX"].numpy(), sj["ZtX"], rtol=1e-5,
                               atol=1e-4)
    sse_j = np.asarray(jax.vmap(jhy.local_sse, in_axes=(0, 0, None, None))(
        jnp.asarray(X), jnp.asarray(Z), jnp.asarray(A), jnp.asarray(act))).sum()
    sse_t = float(thy.local_sse(_t(X), _t(Z), _t(A), _t(act)))
    np.testing.assert_allclose(sse_t, sse_j, rtol=1e-5)


def test_prng_derivations_are_fixed_and_distinct():
    k = prng.key(3)
    assert k.dtype == torch.uint32 and k.tolist() == [0, 3]
    assert prng.fold_in(k, 7).tolist() == prng.fold_in(k, 7).tolist()
    derived = [prng.fold_in(k, i).tolist() for i in range(4)]
    derived += [s.tolist() for s in prng.split(k, 4)]
    assert len({tuple(d) for d in derived}) == 8
    a = torch.rand(5, generator=prng.generator(k, "cpu"))
    b = torch.rand(5, generator=prng.generator(k, "cpu"))
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,k_max,seed", [(8, 2, 0), (30, 12, 1),
                                          (45, 16, 4)])
def test_untransposed_chol_rank1_moves_match_reference(n, k_max, seed):
    rng = np.random.default_rng(seed)
    W, x, act = _padded_chol_case(n, k_max, int(rng.integers(1, k_max + 1)),
                                  seed)
    L = np.linalg.cholesky(W).astype(np.float32)
    x32 = x.astype(np.float32)
    up_t = tibm.chol_rank1_update(_t(L), _t(x32)).numpy()
    up_j = np.asarray(jibm.chol_rank1_update(jnp.asarray(L), jnp.asarray(x32)))
    np.testing.assert_allclose(up_t, up_j, atol=1e-5)
    np.testing.assert_allclose(up_t, np.linalg.cholesky(W + np.outer(x, x)),
                               atol=2e-4)
    Lu = np.linalg.cholesky(W + np.outer(x, x)).astype(np.float32)
    dn_t, ok_t = tibm.chol_rank1_downdate(_t(Lu), _t(x32))
    dn_j, ok_j = jibm.chol_rank1_downdate(jnp.asarray(Lu), jnp.asarray(x32))
    assert bool(ok_t) and bool(ok_j)
    np.testing.assert_allclose(dn_t.numpy(), np.asarray(dn_j), atol=1e-5)
    np.testing.assert_allclose(dn_t.numpy(), np.linalg.cholesky(W),
                               atol=2e-4)
    # the canary fires in both on a downdate that loses definiteness
    _, bad_t = tibm.chol_rank1_downdate(_t(L), _t(3.0 * x32 + act))
    _, bad_j = jibm.chol_rank1_downdate(jnp.asarray(L),
                                        jnp.asarray(3.0 * x32 + act))
    assert not bool(bad_t) and not bool(bad_j)


@pytest.mark.parametrize("k,seed", [(3, 0), (8, 1), (16, 2)])
def test_sherman_morrison_moves_match_reference(k, seed):
    rng = np.random.default_rng(seed)
    Zb = (rng.random((4 * k, k)) < 0.4).astype(np.float64)
    W = Zb.T @ Zb + 0.5 * np.eye(k)
    M = np.linalg.inv(W).astype(np.float32)
    z = Zb[0].astype(np.float32)
    for t_fn, j_fn, sign in ((tibm.sm_update, jibm.sm_update, 1.0),
                             (tibm.sm_downdate, jibm.sm_downdate, -1.0)):
        Mt, ldt = t_fn(_t(M), _t(z))
        Mj, ldj = j_fn(jnp.asarray(M), jnp.asarray(z))
        np.testing.assert_allclose(Mt.numpy(), np.asarray(Mj), atol=1e-5)
        np.testing.assert_allclose(float(ldt), float(ldj), atol=1e-5)
        W2 = W + sign * np.outer(z, z)
        np.testing.assert_allclose(Mt.numpy(), np.linalg.inv(W2), atol=1e-4)
        np.testing.assert_allclose(
            float(ldt), np.linalg.slogdet(W2)[1] - np.linalg.slogdet(W)[1],
            atol=1e-4)


# K+ = 0 (W is the identity), a partly active and a fully active model
@pytest.mark.parametrize("n,k_max,k_act,seed", [
    (40, 8, 3, 0), (60, 12, 12, 1), (30, 6, 0, 2), (200, 16, 9, 3)])
def test_collapsed_loglik_matches_reference(n, k_max, k_act, seed):
    rng = np.random.default_rng(seed)
    D = 20
    act = np.zeros(k_max, np.float32)
    act[np.sort(rng.choice(k_max, size=k_act, replace=False))] = 1.0
    Z = ((rng.random((n, k_max)) < 0.4) * act).astype(np.float32)
    A = rng.standard_normal((k_max, D))
    X = (Z @ A + 0.5 * rng.standard_normal((n, D))).astype(np.float32)
    ZtZ, ZtX = Z.T @ Z, Z.T @ X
    trXtX = np.float32(np.sum(X * X))
    for sx, sa in ((0.5, 1.0), (1.3, 0.7)):
        got = float(tibm.collapsed_loglik(
            torch.tensor(trXtX), _t(ZtX), _t(ZtZ), _t(act), float(n), D,
            torch.tensor(sx), torch.tensor(sa)))
        want = float(jibm.collapsed_loglik(
            jnp.float32(trXtX), jnp.asarray(ZtX), jnp.asarray(ZtZ),
            jnp.asarray(act), jnp.float32(n), D, jnp.float32(sx),
            jnp.float32(sa)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        # the closed form in float64 (G&G 2011 Eq. 26)
        K = act.sum()
        a = act > 0.5
        W = ZtZ[np.ix_(a, a)].astype(np.float64) + (sx / sa) ** 2 * np.eye(
            int(K))
        Za = ZtX[a].astype(np.float64)
        quad = np.sum(np.linalg.solve(W, Za) * Za)
        ll64 = (-0.5 * n * D * np.log(2 * np.pi) - (n - K) * D * np.log(sx)
                - K * D * np.log(sa) - 0.5 * D * np.linalg.slogdet(W)[1]
                - 0.5 / sx**2 * (float(trXtX) - quad))
        np.testing.assert_allclose(got, ll64, rtol=1e-4)
