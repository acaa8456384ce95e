"""The port's kernels against the reference's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the Pallas
kernels run in interpret mode, as tests/test_kernels.py runs them. Inputs
are made with numpy from a seed and handed to both packages. The CUDA
kernels themselves are compared with their plain versions on the card
(tests/test_torch_cuda.py, and chip_smoke.py).

Tolerances:
* gibbs_flip decisions are equal except at most one per case at a float
  boundary, |logit - u| < 1e-4 (1 + |u|): the two packages form R·a_k in
  different summation orders.
* collapsed_row: z by the same rule; v, q, mean at rtol 1e-5, atol 1e-5
  (same moves, reductions over D in another order).
* feature_stats: ZtZ and m are sums of 0/1 products, exact in float32;
  ZtX at rtol 1e-5, atol 1e-4 (summation order).
* gaussian_sse: rtol 1e-5 in float32, 2e-2 for bfloat16 inputs (one
  rounding of the inputs, as in tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collapsed_row import collapsed_row_flip as jax_collapsed_row
from repro.kernels.feature_stats import feature_stats as jax_feature_stats
from repro.kernels.gaussian_sse import gaussian_sse as jax_gaussian_sse
from repro.kernels.gibbs_flip import gibbs_flip_core as jax_gibbs_flip
from _torch_cases import (
    SHAPES,
    _collapsed_row_inputs,
    _inputs,
    _t,
    assert_decisions_match,
    collapsed_row_margin,
    gibbs_margin,
    gibbs_planted_case,
)
from repro_torch.kernels import _build
from repro_torch.kernels.collapsed_row import collapsed_row_flip
from repro_torch.kernels.feature_stats import feature_stats
from repro_torch.kernels.gaussian_sse import gaussian_sse
from repro_torch.kernels.gibbs_flip import gibbs_flip_core, gibbs_flip_gram_ref

torch.set_num_threads(1)


@pytest.mark.parametrize("N,D,K", SHAPES)
def test_gibbs_flip_matches_reference(N, D, K):
    X, Z, A, act, rng = _inputs(N, D, K)
    lpi = rng.standard_normal(K).astype(np.float32)
    u = (rng.standard_normal((N, K)) * 2).astype(np.float32)
    inv2s2 = np.float32(0.5)
    want = np.asarray(jax_gibbs_flip(jnp.asarray(X), jnp.asarray(Z),
                                     jnp.asarray(A), jnp.asarray(lpi),
                                     jnp.asarray(act), jnp.asarray(u),
                                     jnp.float32(inv2s2), block_n=32))
    got = gibbs_flip_core(*_t(X, Z, A, lpi, act, u, inv2s2)).numpy()
    assert set(np.unique(got)).issubset({0.0, 1.0})
    np.testing.assert_array_equal(got[:, act < 0.5], Z[:, act < 0.5])
    assert_decisions_match(
        got, want,
        lambda n, k: (gibbs_margin(X, Z, want, A, lpi, inv2s2, u, n, k),
                      u[n, k]))


# the Gram form of the CUDA kernel (P = X A^T per 64-wide chunk of D in
# float32, chunks, G and the carry in float64) on SHAPES and on planted
# data whose residual dot products cancel (N=256, D=1024, K=64, 40 active)
@pytest.mark.parametrize(
    "N,D,K,planted", [(*s, False) for s in SHAPES] + [(256, 1024, 64, True)])
def test_gibbs_flip_gram_ref_matches_reference(N, D, K, planted):
    if planted:
        X, Z, A, lpi, act, u, inv2s2 = gibbs_planted_case(N, D, K, seed=7)
    else:
        X, Z, A, act, rng = _inputs(N, D, K)
        lpi = rng.standard_normal(K).astype(np.float32)
        u = (rng.standard_normal((N, K)) * 2).astype(np.float32)
        inv2s2 = np.float32(0.5)
    want = np.asarray(jax_gibbs_flip(jnp.asarray(X), jnp.asarray(Z),
                                     jnp.asarray(A), jnp.asarray(lpi),
                                     jnp.asarray(act), jnp.asarray(u),
                                     jnp.float32(inv2s2), block_n=32))
    got = gibbs_flip_gram_ref(*_t(X, Z, A, lpi, act, u, inv2s2)).numpy()
    assert set(np.unique(got)).issubset({0.0, 1.0})
    np.testing.assert_array_equal(got[:, act < 0.5], Z[:, act < 0.5])
    assert_decisions_match(
        got, want,
        lambda n, k: (gibbs_margin(X, Z, want, A, lpi, inv2s2, u, n, k),
                      u[n, k]))


@pytest.mark.parametrize("K,D,frac", [(8, 16, 1.0), (16, 36, 0.7),
                                      (64, 64, 1.0), (5, 7, 0.6),
                                      (12, 128, 0.8)])
def test_collapsed_row_matches_reference(K, D, frac):
    args = _collapsed_row_inputs(K, D, seed=K + D, frac_active=frac)
    zw, vw, qw, mw = (np.asarray(a) for a in jax_collapsed_row(
        *(jnp.asarray(a) for a in args), flavor="pallas"))
    zg, vg, qg, mg = (t.numpy() for t in collapsed_row_flip(*_t(*args)))
    act = args[9]
    np.testing.assert_array_equal(zg[act < 0.5], args[3][act < 0.5])
    assert_decisions_match(zg[None], zw[None],
                           lambda n, k: collapsed_row_margin(args, zw, k))
    np.testing.assert_allclose(vg, vw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qg, qw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mg, mw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,D,K", SHAPES)
def test_feature_stats_matches_reference(N, D, K):
    X, Z, _, _, _ = _inputs(N, D, K)
    ztz_w, ztx_w, m_w = (np.asarray(a) for a in jax_feature_stats(
        jnp.asarray(X), jnp.asarray(Z), block_n=64))
    ztz, ztx, m = (t.numpy() for t in feature_stats(*_t(X, Z)))
    np.testing.assert_array_equal(ztz, ztz_w)
    np.testing.assert_array_equal(m, m_w)
    np.testing.assert_allclose(ztx, ztx_w, rtol=1e-5, atol=1e-4)


# binary Z at SHAPES and the CLI's shape (N=900, D=36, K=32); real-valued
# Z (the kernel takes any Z, not only the sampler's 0/1)
SSE_CASES = ([pytest.param(*s, False, id="-".join(map(str, s)))
              for s in SHAPES + [(900, 36, 32)]]
             + [pytest.param(*s, True, id="-".join(map(str, s)) + "-realz")
                for s in [(100, 36, 16), (33, 20, 5), (900, 36, 32)]])


@pytest.mark.parametrize("N,D,K,real_z", SSE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gaussian_sse_matches_reference(N, D, K, real_z, dtype):
    X, Z, A, act, rng = _inputs(N, D, K)
    if real_z:
        Z = Z * rng.uniform(0.5, 1.5, Z.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = float(jax_gaussian_sse(*(jnp.asarray(a, jdt) for a in (X, Z, A, act)),
                                  block_n=64))
    got = gaussian_sse(*(t.to(tdt) for t in _t(X, Z, A, act)))
    assert got.dtype == torch.float32
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(float(got), want, rtol=rtol)


def test_wrappers_take_plain_version_on_cpu_only():
    X, Z, A, act, _ = _inputs(16, 8, 4)
    meta = [t.to("meta") for t in _t(X, Z)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        feature_stats(*meta)
    with pytest.raises(ValueError, match="several devices"):
        feature_stats(torch.from_numpy(X), meta[1])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A kernel build with no CUDA compiler raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("gibbs_flip",))
