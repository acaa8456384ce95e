"""The tail scan's packed entry point against the reference's scan.

``repro_torch.kernels.collapsed_scan.collapsed_scan`` takes its arguments
exactly as the CUDA kernel does (in-place Z, mask and statistics, the
pre-drawn draws, device scalars sx and sa); on CPU tensors it runs the
plain scan. Here it is held against the reference's public
``collapsed_row_scan(birth="mh", backend="pallas")`` (Pallas in interpret
mode) fed the same key, the port getting the draws that key chain makes
(``jax_draws`` of tests/test_torch_collapsed.py). Decisions may differ
only at float-boundary events: at most MISMATCH_BUDGET Z bits per run,
with equal refresh and saturation counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_collapsed import MISMATCH_BUDGET, _case, jax_draws

from repro.core.ibp.collapsed import collapsed_row_scan as jax_scan
from repro_torch.kernels.collapsed_scan import collapsed_scan

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,K,k_live,refresh,alpha", [
    (20, 8, 3, 8, 60.0), (21, 32, 6, 16, 240.0)])
def test_packed_scan_matches_reference(seed, K, k_live, refresh, alpha):
    R, Z, act = _case(seed, n_rows=48, K=K, k_live=k_live)
    n_rows = Z.shape[0]
    N_global = 4.0 * n_rows
    sx, sa = 0.5, 1.0
    stats = (Z.T @ Z, Z.T @ R, Z.sum(0))
    key = jax.random.key(300 + seed)
    out = jax_scan(*(jnp.asarray(a) for a in (Z, act, *stats, R)), key,
                   jnp.float32(alpha), jnp.float32(sx), jnp.float32(sa),
                   N=N_global, birth="mh", backend="pallas",
                   refresh_every=refresh, u_chunk_rows=n_rows)
    Zw, act_w = np.asarray(out[0]), np.asarray(out[1])

    draws = jax_draws(key, n_rows, K, alpha, N_global)
    Zg, act_g, ZtZ_g, ZtX_g, m_g = (
        torch.from_numpy(np.array(a, np.float32))
        for a in (Z, act, *stats))
    counts = collapsed_scan(Zg, act_g, ZtZ_g, ZtX_g, m_g,
                            torch.from_numpy(R), draws.u_logit, draws.j_prop,
                            draws.log_u_acc, torch.tensor(sx),
                            torch.tensor(sa), N=N_global,
                            refresh_every=refresh, drift_tol=1e-2)
    Zg, act_g = Zg.numpy(), act_g.numpy()

    mism = int(np.sum(Zg * act_g != Zw * act_w))
    assert mism <= MISMATCH_BUDGET, f"{mism} bits diverged (seed={seed})"
    assert int(counts[0]) == int(out[5])  # refreshes (cadence + monitor)
    assert int(counts[1]) == int(out[6])  # capacity-vetoed births
    # the scan really moved the tail: flips or births happened
    assert np.sum(Zw != Z) > 0
    # the in-place statistics are exact against the final Z
    Zm = Zg * act_g
    np.testing.assert_array_equal(ZtZ_g.numpy(), Zm.T @ Zm)
    np.testing.assert_array_equal(m_g.numpy(), Zm.sum(0))
    np.testing.assert_allclose(ZtX_g.numpy(), Zm.T @ R, rtol=1e-5, atol=1e-4)
