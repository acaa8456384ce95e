"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and the CUDA toolkit; without a GPU they
skip. Run them on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_torch_kernels.py; feature_stats and
gaussian_sse are held against the plain version evaluated in float64 (a
float32 sum in any order is itself off by more than atol on long
reductions). The tail scan kernel is held against its plain version (the
Python row loop, flips through collapsed_row_flip_ref) on the same inputs
and draws: Z, the mask, m, ZtZ and the saturation count equal, ZtX at
feature_stats' tolerance; the two may first differ only at a
float-boundary event, whose row and margin the test names. The same holds
for the serial sweep's scan with Gibbs births, whose launches are also
bitwise repeatable, and for the chained launch of C tails, each chain of
which is also bitwise equal to a single-chain launch from its inputs.
The serving scorer (plain PyTorch batched over the
bank's samples) is held on the card against its own run on the CPU, and
its naive baseline is checked to sweep through gibbs_flip. No JAX is
imported: the GPU machine has none.
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
    gibbs_planted_case,
    bank_samples,
    packed_scan_case,
    scan_case,
    scan_divergence,
    scorer_divergence,
)

from repro_torch import prng, tracing
from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
from repro_torch.core.ibp import predict
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.collapsed_row import collapsed_row_flip, collapsed_row_flip_ref
from repro_torch.kernels.collapsed_scan import collapsed_scan, collapsed_scan_ref
from repro_torch.kernels.feature_stats import feature_stats, feature_stats_ref
from repro_torch.kernels.gaussian_sse import gaussian_sse, gaussian_sse_ref
from repro_torch.kernels.gibbs_flip import (
    gibbs_flip_core,
    gibbs_flip_max_k,
    gibbs_flip_ref,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# beside SHAPES: K=70 (52 active columns, G in shared memory), K=130 (103
# active: P in two stages of 64 columns, G read from L2), K=256 (214
# active: four stages, Z and u read from global memory too), K=400 (328
# active: two column passes of 256 on an H100) and K=700 (573 active:
# three passes), K=1, row counts that are not multiples of the 64-row
# tile, an all-zero mask ("inactive"), planted data whose dot products
# cancel ("planted") and a grown K_max of 128 with every column active,
# the serial baseline's layout ("all_active")
@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K,case", [
    *[(*s, "random") for s in SHAPES + [(1000, 1500, 12)]],
    (1000, 300, 70, "random"), (517, 200, 130, "random"),
    (200, 64, 256, "random"), (300, 96, 400, "random"),
    (150, 64, 700, "random"), (300, 50, 1, "random"),
    (129, 64, 64, "inactive"), (2049, 1024, 64, "planted"),
    (4099, 1024, 128, "all_active")])
def test_gibbs_flip_kernel_matches_plain(cuda, N, D, K, case):
    if case == "planted":
        X, Z, A, lpi, act, u, inv2s2 = gibbs_planted_case(N, D, K, seed=N)
    else:
        X, Z, A, act, rng = _inputs(N, D, K)
        lpi = rng.standard_normal(K).astype(np.float32)
        u = (rng.standard_normal((N, K)) * 2).astype(np.float32)
        inv2s2 = np.float32(0.5)
        if case == "inactive":
            act = np.zeros_like(act)
        elif case == "all_active":
            act = np.ones_like(act)
    args = [t.to(cuda) for t in _t(X, Z, A, lpi, act, u, inv2s2)]
    first = gibbs_flip_core(*args)
    assert torch.equal(first, gibbs_flip_core(*args))  # bitwise repeatable
    got = first.cpu().numpy()
    want = gibbs_flip_ref(*args).cpu().numpy()
    np.testing.assert_array_equal(got[:, act < 0.5], Z[:, act < 0.5])
    assert_decisions_match(
        got, want,
        lambda n, k: (gibbs_margin(X, Z, want, A, lpi, inv2s2, u, n, k),
                      u[n, k]), rel=1e-3, budget=max(1, N * K // 100000))


@pytest.mark.cuda
def test_gibbs_flip_kernel_rejects_too_many_columns(cuda):
    K = gibbs_flip_max_k(cuda) + 1
    X, Z, A, act, rng = _inputs(8, 16, K)
    args = [t.to(cuda) for t in _t(X, Z, A, np.zeros(K, np.float32), act,
                                     np.zeros_like(Z), np.float32(0.5))]
    with pytest.raises(ValueError, match=f"at most {K - 1}"):
        gibbs_flip_core(*args)
    # a sampler that would need it fails when built, not at its first sweep
    with pytest.raises(ValueError, match=f"K_max={K}"):
        build_sampler(SamplerSpec(P=2, K_max=K), IBPHypers(), X, device=cuda)


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


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K", [(1000, 36, 12), (777, 100, 5),
                                   (4099, 1024, 64), (33, 20, 70),
                                   (4099, 1024, 128)])
def test_feature_stats_kernel_exact_and_repeatable(cuda, N, D, K):
    X, Z, _, _, _ = _inputs(N, D, K, seed=N)
    X, Z = (t.to(cuda) for t in _t(X, Z))
    got = feature_stats(X, Z)
    want = feature_stats_ref(X.double(), Z.double())
    np.testing.assert_array_equal(got[0].double().cpu(), want[0].cpu())
    np.testing.assert_array_equal(got[2].double().cpu(), want[2].cpu())
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    for a, b in zip(got, feature_stats(X, Z)):
        assert torch.equal(a, b)  # no atomics: every call bitwise equal


# shapes that are not tile multiples (128 rows, 64 columns, 16-64 k), one
# with K > 64 (Z walked in two chunks), the eval's N=1024 (D split across
# blocks), a sync-like 4099 rows, and the sync after a K_max growth to 128
@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K", [(1000, 36, 12), (777, 100, 5), (33, 20, 70),
                                   (1024, 1024, 64), (4099, 1024, 64),
                                   (4099, 1024, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gaussian_sse_kernel_matches_plain(cuda, N, D, K, dtype):
    X, Z, A, act, rng = _inputs(N, D, K, seed=N + K)
    Zr = Z * rng.uniform(0.5, 1.5, Z.shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    rtol = 1e-5 if dtype == "float32" else 2e-2
    cases = {"binary": (Z, act), "real_z": (Zr, act),
             "inactive": (Z, np.zeros_like(act))}
    for case, (z, a) in cases.items():
        Xd, Zd, Ad, actd = (t.to(cuda, tdt) for t in _t(X, z, A, a))
        got = gaussian_sse(Xd, Zd, Ad, actd)
        assert got.dtype == torch.float32 and got.shape == ()
        want = float(gaussian_sse_ref(Xd.double(), Zd, Ad, actd))
        np.testing.assert_allclose(float(got), want, rtol=rtol, err_msg=case)
        if dtype == "bfloat16":  # and the float32 plain version
            np.testing.assert_allclose(
                float(got), float(gaussian_sse_ref(Xd, Zd, Ad, actd)),
                rtol=rtol, err_msg=case)
        # no atomics: every call bitwise equal
        assert torch.equal(got, gaussian_sse(Xd, Zd, Ad, actd)), case


SCAN_SX, SCAN_SA = 0.5, 1.0


def _scan(fn, case, dev, n_rows=None, refresh=16, **kw):
    """One scan of ``case`` by ``fn`` (the kernel or the plain version),
    with Gibbs births where the case has Gumbel noise; ``kw`` (flavor,
    B) is passed on."""
    rows = slice(None, n_rows)
    t = {k: torch.tensor(v[rows] if k in ("Z", "X", "u_logit", "j_prop",
                                           "log_u_acc", "gumbel") else v,
                         device=dev)
         for k, v in case.items()}  # copies: the scan works in place
    N = 4.0 * case["X"].shape[0]
    counts = fn(t["Z"], t["active"], t["ZtZ"], t["ZtX"], t["m"], t["X"],
                t["u_logit"], t["j_prop"], t["log_u_acc"],
                torch.tensor(SCAN_SX, device=dev),
                torch.tensor(SCAN_SA, device=dev), N=N, refresh_every=refresh,
                drift_tol=1e-2, gumbel=t.get("gumbel"), alpha=t.get("alpha"),
                **kw)
    out = {k: t[k].cpu().numpy() for k in ("Z", "active", "ZtZ", "ZtX", "m")}
    return out, counts.cpu().numpy()


# K=8 D=1024 is the main path's tail; D=36 the CLI's; K=16 D=1024 is a
# grown tail whose carry still fits one block's shared memory, near its
# limit; K=32 D=1024 keeps its carry in global memory
@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,K,D", [(512, 8, 1024), (600, 8, 36),
                                        (512, 16, 1024), (256, 32, 1024)])
def test_collapsed_scan_kernel_matches_plain(cuda, n_rows, K, D):
    case = scan_case(n_rows, K, D, seed=K + D)
    got, cg = _scan(collapsed_scan, case, cuda)
    want, cw = _scan(collapsed_scan_ref, case, cuda)
    # the case exercises refreshes and births (the singleton slot drops)
    assert cw[0] > 0 and np.any(want["Z"][:, case["active"] < 0.5] > 0)
    ev = scan_divergence(
        case, want["Z"], got["Z"],
        lambda n: (_scan(collapsed_scan_ref, case, cuda, n)[0][k]
                   for k in ("active", "m")),
        SCAN_SX, SCAN_SA, 4.0 * n_rows)
    if ev is not None:
        n, what, margin, u = ev
        assert margin < 1e-3 * (1.0 + abs(u)), (
            f"scans diverge at row {n} ({what}) away from a float boundary: "
            f"margin {margin}")
        print(f"float-boundary event at row {n} ({what}), margin {margin}")
        np.testing.assert_array_equal(got["Z"][:n], want["Z"][:n])
        return  # the scans follow different chains from there
    for k in ("Z", "active", "m", "ZtZ"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["ZtX"], want["ZtX"], rtol=1e-5, atol=1e-4)
    assert cg[1] == cw[1]  # capacity-vetoed births


# the serial sweep's scan, Gibbs births: K=8 and 16 keep the carry in
# shared memory (the Gumbel values through the ring), 32 and 64 in global
# memory; alpha = N/4 (N = 4 n_rows) makes births common, so the free
# capacity binds; D=36 is Cambridge data's width
@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,K,D,alpha", [
    (512, 8, 1024, 3.0), (1024, 16, 1024, 3.0), (1024, 32, 1024, 1024.0),
    (600, 12, 36, 3.0), (256, 64, 1024, 3.0)])
def test_collapsed_scan_gibbs_kernel_matches_plain(cuda, n_rows, K, D, alpha):
    case = scan_case(n_rows, K, D, seed=K + D + 1, alpha=alpha)
    got, cg = _scan(collapsed_scan, case, cuda)
    again, ca = _scan(collapsed_scan, case, cuda)
    for k in got:  # two launches bitwise equal
        np.testing.assert_array_equal(got[k], again[k], err_msg=k)
    np.testing.assert_array_equal(cg, ca)
    want, cw = _scan(collapsed_scan_ref, case, cuda)
    born = want["Z"][:, case["active"] < 0.5].sum(0)
    assert cw[0] > 0 and np.count_nonzero(born) >= 2  # refreshes, births
    assert cg[1] == cw[1] == 0  # no saturation count in Gibbs mode
    ev = scan_divergence(
        case, want["Z"], got["Z"],
        lambda n: (_scan(collapsed_scan_ref, case, cuda, n)[0][k]
                   for k in ("active", "m")),
        SCAN_SX, SCAN_SA, 4.0 * n_rows)
    if ev is not None:
        n, what, margin, u = ev
        assert margin < 1e-3 * (1.0 + abs(u)), (
            f"scans diverge at row {n} ({what}) away from a float boundary: "
            f"margin {margin}")
        print(f"float-boundary event at row {n} ({what}), margin {margin}")
        np.testing.assert_array_equal(got["Z"][:n], want["Z"][:n])
        return  # the scans follow different chains from there
    for k in ("Z", "active", "m", "ZtZ"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["ZtX"], want["ZtX"], rtol=1e-5, atol=1e-4)
    assert cg[0] == cw[0]  # refreshes


# C independent tails in one chained launch (the multichain sampler's):
# K=8 keeps each chain's carry in its block's shared memory, K=32 in its
# own global arena; each chain bitwise equal to a single-chain launch
# from its inputs, and held against the plain scan as above
@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["fast", "pallas"])
@pytest.mark.parametrize("C,n_rows,K,D", [(4, 512, 8, 1024),
                                          (4, 256, 32, 1024),
                                          (3, 600, 8, 36)])
def test_collapsed_scan_chained_kernel_matches_single_launches(
        cuda, flavor, C, n_rows, K, D):
    cases = [scan_case(n_rows, K, D, seed=K + D + 7 * c) for c in range(C)]
    fields = ("Z", "active", "ZtZ", "ZtX", "m", "X", "u_logit", "j_prop",
              "log_u_acc")
    sx = torch.full((C,), SCAN_SX, device=cuda)
    sa = torch.full((C,), SCAN_SA, device=cuda)
    N = 4.0 * n_rows
    kw = dict(N=N, refresh_every=16, drift_tol=1e-2, flavor=flavor)
    st = {f: torch.tensor(np.stack([c[f] for c in cases]), device=cuda)
          for f in fields}
    reset_launch_counts()
    counts = collapsed_scan(*(st[f] for f in fields), sx, sa, **kw)
    assert launch_counts()["collapsed_scan"] == 1 and counts.shape == (C, 3)
    for c, case in enumerate(cases):
        one, c1 = _scan(collapsed_scan, case, cuda, flavor=flavor)
        np.testing.assert_array_equal(counts[c].cpu().numpy(), c1)
        for f in ("Z", "active", "ZtZ", "ZtX", "m"):
            np.testing.assert_array_equal(st[f][c].cpu().numpy(), one[f],
                                          err_msg=f"chain {c} {f}")
        want, cw = _scan(collapsed_scan_ref, case, cuda, flavor=flavor)
        ev = scan_divergence(
            case, want["Z"], one["Z"],
            lambda n: (_scan(collapsed_scan_ref, case, cuda, n,
                             flavor=flavor)[0][k] for k in ("active", "m")),
            SCAN_SX, SCAN_SA, N)
        if ev is not None:
            n, what, margin, u = ev
            assert margin < 1e-3 * (1.0 + abs(u)), (
                f"chain {c} diverges from the plain scan at row {n} "
                f"({what}) away from a float boundary: margin {margin}")
            continue  # the scans follow different chains from there
        for f in ("Z", "active", "m", "ZtZ"):
            np.testing.assert_array_equal(one[f], want[f], err_msg=f)
        np.testing.assert_array_equal(c1, cw)
    # every chain scanned its own rows: the results differ between chains
    assert not torch.equal(st["Z"][0], st["Z"][1])


# the hybrid tail's scan while tracing records: the TRACE instance (the
# cell's shape, 4096 rows at K=8, D=36, MH births, the rss flip; and a
# chained launch of 3) gives the untraced instance's Z, statistics and
# counts bitwise, and its four row phases take 90-100% of the launch's
# cycles, each a part, over every row it scanned
@pytest.mark.cuda
@pytest.mark.parametrize("C,n_rows", [(1, 4096), (3, 600)])
def test_collapsed_scan_traced_instance_matches_untraced(cuda, C, n_rows):
    cases = [scan_case(n_rows, 8, 36, seed=44 + c) for c in range(C)]
    fields = ("Z", "active", "ZtZ", "ZtX", "m", "X", "u_logit", "j_prop",
              "log_u_acc")

    def scan():
        st = {f: torch.tensor(np.stack([c[f] for c in cases]) if C > 1
                              else cases[0][f], device=cuda) for f in fields}
        lead = (C,) if C > 1 else ()
        counts = collapsed_scan(
            *(st[f] for f in fields), torch.full(lead, SCAN_SX, device=cuda),
            torch.full(lead, SCAN_SA, device=cuda), N=4.0 * n_rows,
            refresh_every=16, drift_tol=1e-2, flavor="fast")
        return {f: st[f].cpu() for f in fields[:5]}, counts.cpu()

    off, c_off = scan()
    with tracing.recording() as rec:
        on, c_on = scan()
    assert torch.equal(c_on, c_off) and int(c_off.reshape(-1, 3)[0, 0]) > 0
    for f in off:
        assert torch.equal(on[f], off[f]), f
    cyc = rec.scan
    assert cyc["rows"] == C * n_rows, cyc
    parts = [cyc[p] for p in ("move", "refresh", "flip", "birth")]
    assert all(v > 0 for v in parts), cyc
    share = sum(parts) / cyc["total"]
    print(f"C={C} rows={n_rows}: cycles {cyc}, phases {share:.4f} of total")
    assert 0.9 <= share <= 1.0, cyc


# the multichain sampler's tails: one collapsed_scan launch a
# sub-iteration for all C chains; the sweeps, feature_stats and
# gaussian_sse launch once a chain
@pytest.mark.cuda
def test_multichain_iteration_launches_one_scan_per_sub_iteration(cuda):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 36)).astype(np.float32)
    C, L = 4, 3
    s = build_sampler(SamplerSpec(P=3, K_max=16, K_tail=8, L=L,
                                  chains="vmap", n_chains=C),
                      IBPHypers(), X, device=cuda)
    gs, ss = s.init()
    reset_launch_counts()
    gs, ss = s.step(gs, ss)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["collapsed_scan"] == L
    assert counts["gibbs_flip"] == C * L
    assert counts["feature_stats"] == C and counts["gaussian_sse"] == C
    assert gs.key.shape == (C, 2) and torch.isfinite(gs.sigma_x).all()
    reset_launch_counts()
    s.stale(gs, ss)
    assert launch_counts()["collapsed_scan"] == L


def _hold_packed(case, dev, **kw):
    """The packed kernel against its plain version on ``case`` with the
    scan's ``kw`` (flavor, B, start_row): two launches bitwise equal; the
    two scans first differ only at a float-boundary event, else Z, the
    mask, m and ZtZ equal, ZtX close and the counts (refreshes, n_sat,
    ovf_row) equal. Returns the plain scan's (out, counts)."""
    got, cg = _scan(collapsed_scan, case, dev, **kw)
    again, ca = _scan(collapsed_scan, case, dev, **kw)
    for k in got:  # two launches bitwise equal
        np.testing.assert_array_equal(got[k], again[k], err_msg=k)
    np.testing.assert_array_equal(cg, ca)
    want, cw = _scan(collapsed_scan_ref, case, dev, **kw)
    n_rows = case["X"].shape[0]
    ev = scan_divergence(
        case, want["Z"], got["Z"],
        lambda n: (_scan(collapsed_scan_ref, case, dev, n, **kw)[0][k]
                   for k in ("active", "m")),
        SCAN_SX, SCAN_SA, 4.0 * n_rows)
    if ev is not None:
        n, what, margin, u = ev
        assert margin < 1e-3 * (1.0 + abs(u)), (
            f"scans diverge at row {n} ({what}) away from a float boundary: "
            f"margin {margin}")
        print(f"float-boundary event at row {n} ({what}), margin {margin}")
        np.testing.assert_array_equal(got["Z"][:n], want["Z"][:n])
        return want, cw  # the scans follow different chains from there
    for k in ("Z", "active", "m", "ZtZ"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["ZtX"], want["ZtX"], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(cg, cw)  # refreshes, n_sat, ovf_row
    return want, cw


# the packed carry: the rss flip with the carried G (flavor "fast") and
# the mean form ("pallas"), on a block of B of K_can columns. K=8 MH is
# the hybrid tail; the buckets 16 (shared memory) and 32 (global memory)
# of K_can=64 run Gibbs births with the other columns out of the block;
# in the last case the block has 2 free slots for the case's 3 births, so
# the scan stops at the overflowing row (ovf_row equal to the plain scan's)
@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["fast", "pallas"])
@pytest.mark.parametrize("n_rows,K_can,D,width,B,gibbs,ovf", [
    (512, 8, 1024, 8, 8, False, False), (600, 8, 36, 8, 8, False, False),
    (512, 64, 1024, 24, 16, True, False), (256, 64, 1024, 48, 32, True, False),
    (512, 64, 36, 24, 16, True, False), (512, 64, 1024, 39, 16, True, True)])
def test_collapsed_scan_packed_kernel_matches_plain(cuda, flavor, n_rows,
                                                    K_can, D, width, B,
                                                    gibbs, ovf):
    case = packed_scan_case(n_rows, K_can, D, width, seed=K_can + D + B,
                            alpha=3.0 if gibbs else None)
    kw = dict(flavor=flavor, B=B)
    want, cw = _hold_packed(case, cuda, **kw)
    if ovf:
        assert cw[2] >= 0  # built to overflow
    else:
        assert cw[0] > 0 and cw[2] == -1  # refreshes, no overflow
    out_of_block = np.ones(K_can, bool)
    out_of_block[np.argsort(case["active"] < 0.5, kind="stable")[:B]] = False
    assert not want["Z"][:, out_of_block].any()  # nothing left the block


# a resumed segment (start_row > 0): the ring's stage index, its first
# prefetch at start_row and the drain at the exit, at an odd start row
# on the tail's K=8 and on buckets 16 (shared memory) and 32 (global
# memory) of K_can=64; and the resume after an overflow, as the packed
# sweep runs it: the plain scan at B=16 stops at ovf_row, and from its
# state both scans go on from that row at B=32
@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["fast", "pallas"])
@pytest.mark.parametrize("n_rows,K_can,D,width,B,gibbs,start", [
    (512, 8, 1024, 8, 8, False, 129), (512, 64, 1024, 24, 16, True, 77),
    (256, 64, 1024, 48, 32, True, 33), (512, 64, 1024, 39, 32, True, None)])
def test_collapsed_scan_packed_kernel_resumes(cuda, flavor, n_rows, K_can, D,
                                              width, B, gibbs, start):
    seed = K_can + D + (16 if start is None else B)
    case = packed_scan_case(n_rows, K_can, D, width, seed=seed,
                            alpha=3.0 if gibbs else None)
    if start is None:  # the overflow case of the test above
        st, c = _scan(collapsed_scan_ref, case, cuda, flavor=flavor, B=16)
        start = int(c[2])
        assert start > 0 and st["active"].sum() <= B
        case = dict(case, **st)
    want, cw = _hold_packed(case, cuda, flavor=flavor, B=B, start_row=start)
    assert cw[2] == -1  # reached the last row
    np.testing.assert_array_equal(want["Z"][:start], case["Z"][:start])


def _serving_case(K_max, lives, D, B, masked, seed):
    bb = predict.BankBuilder(K_max)
    for kw in bank_samples(K_max, lives, D, sigma_x=0.6, seed=seed,
                           scale=0.3):
        bb.add(**kw)
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((B, D)).astype(np.float32)
    mask = ((rng.random((B, D)) > 0.25).astype(np.float32) if masked
            else None)
    return bb, X, mask, rng


# the batched scorer on the card against the same call on the CPU, on the
# same bank, rows and draws: a (sample, row) chain whose draws differ must
# hold a float-boundary event (margin < 1e-4, ``scorer_divergence``);
# probs to 1e-4 and row log-likelihoods to 1e-5 relative on the others
@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("K_max,lives,D,B,n_sweeps", [
    (16, (5, 9, 7), 64, 32, 8), (64, (40, 33, 60, 12), 1024, 256, 3)])
def test_batched_scorer_on_card_matches_cpu(cuda, masked, K_max, lives, D, B,
                                            n_sweeps):
    bb, X, mask, rng = _serving_case(K_max, lives, D, B, masked, K_max)
    banks = {d: bb.build(d) for d in ("cpu", cuda)}
    u = rng.random((len(lives), n_sweeps, banks["cpu"].K, B),
                   dtype=np.float32)
    out = {}
    for d, bank in banks.items():
        t = lambda a: None if a is None else torch.from_numpy(a).to(d)  # noqa: E731
        out[d] = [o.cpu().numpy() for o in predict._score_bank(
            bank, t(X), t(mask), t(u), n_sweeps, n_sweeps // 2)]
    (pc, Zc, lc), (pg, Zg, lg) = out["cpu"], out[cuda]
    fields = {f: getattr(banks["cpu"], f).numpy() for f in
              ("A", "pi", "active", "sigma_x", "chol_f")}
    events, _ = scorer_divergence(fields, X, mask, u, n_sweeps, Zc, Zg)
    same = np.ones(lc.shape, bool)
    for s, b, _ in events:
        same[s, b] = False
    np.testing.assert_allclose(pg[same], pc[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(lg[same], lc[same], rtol=1e-5)


# the naive baseline sweeps each sample's rows through gibbs_flip: S x
# n_sweeps launches a call, and its mixture estimates the batched one's
@pytest.mark.cuda
def test_naive_scorer_sweeps_through_gibbs_flip(cuda):
    bb, X, _, _ = _serving_case(64, (20, 31, 12), 1024, 256, False, 5)
    bank = bb.build(cuda)
    key = prng.key(3)
    reset_launch_counts()
    naive = predict.predictive_loglik_naive(bank, X, key, n_sweeps=3)
    assert launch_counts().get("gibbs_flip") == bank.S * 3
    batched = predict.predictive_loglik(bank, X, key, n_sweeps=8)
    assert naive.shape == (256,) and torch.isfinite(naive).all()
    assert float((naive - batched).abs().max()) < \
        0.05 * float(batched.abs().max())
