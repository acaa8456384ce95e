"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and the CUDA toolkit; without a GPU they
skip. Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_torch_kernels.py; feature_stats and
gaussian_sse are held against the plain version evaluated in float64 (a
float32 sum in any order is itself off by more than atol on long
reductions). No JAX is imported: the GPU machine has none.
"""
import numpy as np
import pytest
import torch
from _torch_cases import (
    SHAPES,
    _collapsed_row_inputs,
    _inputs,
    _t,
    assert_decisions_match,
    collapsed_row_margin,
    gibbs_margin,
)

from repro_torch.kernels.collapsed_row import collapsed_row_flip, collapsed_row_flip_ref
from repro_torch.kernels.feature_stats import feature_stats, feature_stats_ref
from repro_torch.kernels.gaussian_sse import gaussian_sse, gaussian_sse_ref
from repro_torch.kernels.gibbs_flip import gibbs_flip_core, gibbs_flip_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K", SHAPES + [(1000, 1500, 12)])
def test_gibbs_flip_kernel_matches_plain(cuda, N, D, K):
    X, Z, A, act, rng = _inputs(N, D, K)
    lpi = rng.standard_normal(K).astype(np.float32)
    u = (rng.standard_normal((N, K)) * 2).astype(np.float32)
    args = [t.to(cuda) for t in _t(X, Z, A, lpi, act, u, np.float32(0.5))]
    got = gibbs_flip_core(*args).cpu().numpy()
    want = gibbs_flip_ref(*args).cpu().numpy()
    assert_decisions_match(
        got, want,
        lambda n, k: (gibbs_margin(X, Z, want, A, lpi, 0.5, u, n, k),
                      u[n, k]), rel=1e-3, budget=max(1, N * K // 100000))


@pytest.mark.cuda
@pytest.mark.parametrize("K,D", [(8, 1024), (64, 1024), (5, 7)])
def test_collapsed_row_kernel_matches_plain(cuda, K, D):
    args = _collapsed_row_inputs(K, D, seed=K + D)
    targs = [t.to(cuda) for t in _t(*args)]
    zg, vg, qg, mg = (t.cpu().numpy() for t in collapsed_row_flip(*targs))
    zw, vw, qw, mw = (t.cpu().numpy() for t in collapsed_row_flip_ref(*targs))
    assert_decisions_match(zg[None], zw[None],
                           lambda n, k: collapsed_row_margin(args, zw, k))
    for a, b in ((vg, vw), (qg, qw), (mg, mw)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K", SHAPES)
def test_stats_kernels_match_plain(cuda, N, D, K):
    X, Z, A, act, _ = _inputs(N, D, K)
    X, Z, A, act = (t.to(cuda) for t in _t(X, Z, A, act))
    for got, want in zip(feature_stats(X, Z),
                         feature_stats_ref(X.double(), Z.double())):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        float(gaussian_sse(X, Z, A, act)),
        float(gaussian_sse_ref(X.double(), Z, A, act)), rtol=1e-5)
