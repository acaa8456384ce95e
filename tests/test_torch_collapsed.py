"""The port's tail row scan against the reference's.

The reference's hybrid tail runs ``_packed_scan`` at the full-width block
with ``carry_g=False``; its ``"jnp"`` flip flavor is bitwise the Pallas
body (tests/test_kernels.py) and faster in interpret mode. Both scans get
the same inputs and the port is fed the draws the reference's key chain
makes (collapsed.py: per row split(key, 4) -> (key, kbits, kdish, _),
logit-uniforms from kbits, split(kdish) -> Poisson proposal + accept
uniform; Gibbs births take kdish's Gumbel noise). Decisions may differ
only at float-boundary events: at most MISMATCH_BUDGET Z bits per run
(the budget of tests/test_collapsed_fast.py), with equal saturation
counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ibp.collapsed import J_MAX, _packed_scan
from repro.data import cambridge_data
from repro_torch.core.ibp.collapsed import ScanDraws, collapsed_row_scan

torch.set_num_threads(1)

MISMATCH_BUDGET = 2  # bits per run; boundary events, not drift


def jax_draws(key, n_rows, K, alpha, N, birth="mh"):
    """The draws the reference's key chain makes for ``n_rows`` rows: the
    flip uniforms from kbits and, from kdish, the MH proposal and accept
    uniform (``birth="mh"``) or the Gumbel noise ``jax.random.categorical``
    adds to the Gibbs logits (``birth="gibbs"``)."""
    def key_step(k, _):
        k2, kbits, kdish, _ = jax.random.split(k, 4)
        return k2, (kbits, kdish)

    _, (kbits, kdish) = jax.lax.scan(key_step, key, None, length=n_rows)
    uu = jax.vmap(lambda k: jax.random.uniform(k, (K,), jnp.float32))(kbits)
    uu = jnp.clip(uu, 1e-7, 1.0 - 1e-7)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    u_logit = t(jnp.log(uu) - jnp.log1p(-uu))
    if birth == "gibbs":
        g = jax.vmap(lambda k: jax.random.gumbel(k, (J_MAX + 1,),
                                                 jnp.float32))(kdish)
        return ScanDraws(u_logit=u_logit, gumbel=t(g))
    lam = jnp.float32(alpha) / N

    def dish(k):
        kprop, kacc = jax.random.split(k)
        return (jax.random.poisson(kprop, lam).astype(jnp.float32),
                jnp.log(jax.random.uniform(kacc, (), jnp.float32)))

    j_prop, log_u = jax.vmap(dish)(kdish)
    return ScanDraws(u_logit=u_logit, j_prop=t(j_prop), log_u_acc=t(log_u))


def _case(seed, n_rows=60, K=8, k_live=3):
    X, _, _ = cambridge_data(N=n_rows, sigma_n=0.5, seed=seed)
    rng = np.random.default_rng(seed)
    Z = np.zeros((n_rows, K), np.float32)
    Z[:, :k_live] = rng.random((n_rows, k_live)) < 0.4
    act = (Z.sum(0) > 0).astype(np.float32)
    # the tail sees a residual: take out a rough fit of the live columns
    R = (X - Z @ (np.linalg.pinv(Z) @ X)).astype(np.float32)
    return R, Z, act


# alpha = N_global makes births common (Poisson(1) proposals) and, with
# few free columns, capacity-vetoed (the saturation count)
@pytest.mark.parametrize("seed,refresh,alpha,K", [
    (0, 64, 3.0, 8), (1, 8, 3.0, 8), (2, 3, 240.0, 8), (3, 64, 240.0, 5),
    (4, 16, 60.0, 6)])
def test_tail_scan_matches_reference(seed, refresh, alpha, K):
    R, Z, act = _case(seed, K=K)
    n_rows = Z.shape[0]
    N_global = 4.0 * n_rows
    sx, sa = 0.5, 1.0
    stats = (Z.T @ Z, Z.T @ R, Z.sum(0))
    key = jax.random.key(100 + seed)
    out = _packed_scan(
        *(jnp.asarray(a) for a in (Z, act, *stats, R)), key,
        jnp.float32(alpha), jnp.float32(sx), jnp.float32(sa), 0,
        N=N_global, birth="mh", B=K, refresh_every=refresh,
        flip_flavor="jnp", u_chunk_rows=n_rows, carry_g=False)
    Zw, act_w, n_sat_w = np.asarray(out[0]), np.asarray(out[1]), int(out[6])

    draws = jax_draws(key, n_rows, K, alpha, N_global)
    tz = [torch.from_numpy(np.asarray(a)) for a in (Z, act, *stats, R)]
    got = collapsed_row_scan(*tz, torch.tensor(sx), torch.tensor(sa), draws,
                             N=N_global, refresh_every=refresh)
    Zg, act_g, n_sat_g = got[0].numpy(), got[1].numpy(), int(got[6])

    mism = int(np.sum(Zg * act_g != Zw * act_w))
    assert mism <= MISMATCH_BUDGET, f"{mism} bits diverged (seed={seed})"
    assert n_sat_g == n_sat_w
    assert int(got[5]) == int(out[5])  # refreshes (cadence + monitor)
    # the scan really moved the tail: births and flips happened
    assert np.sum(Zw != Z) > 0
    # carried statistics stay exact against the final Z
    ZtZ_g, m_g = got[2].numpy(), got[4].numpy()
    Zm = Zg * act_g
    np.testing.assert_allclose(ZtZ_g, Zm.T @ Zm, atol=1e-4)
    np.testing.assert_allclose(m_g, Zm.sum(0), atol=1e-4)


def test_tail_scan_refreshes_on_cadence():
    R, Z, act = _case(5)
    n_rows, K = Z.shape
    draws = jax_draws(jax.random.key(5), n_rows, K, 3.0, 4.0 * n_rows)
    tz = [torch.from_numpy(np.asarray(a)) for a in
          (Z, act, Z.T @ Z, Z.T @ R, Z.sum(0), R)]
    out = collapsed_row_scan(*tz, torch.tensor(0.5), torch.tensor(1.0),
                             draws, N=4.0 * n_rows, refresh_every=16)
    # every 16th row refreshes at least (the probe may add more)
    assert int(out[5]) >= n_rows // 16
