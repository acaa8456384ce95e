"""Peaks of the card and the work each kernel of the port needs.

Frozen here so that a later change to the program cannot move its own
yardstick. Work is counted from shapes and live counts: every input
byte read once and every output byte written once, whatever the kernel
reads again, and only the arithmetic that these inputs need (live
columns, not the padded width). A kernel's least time is the largest of
three bounds:

* ``tensor``: float32 matrix products the kernel issues on the tensor
  cores, at the TF32 rate. ``gibbs_flip``, ``feature_stats`` and
  ``gaussian_sse`` issue ``mma.sync`` TF32 products with the 3xTF32
  split (``kernels/csrc/mma.cuh``); no exact float32 split can beat one
  TF32 pass, so the TF32 rate bounds them from below.
* ``fp32``: other float32 arithmetic, at the rate outside the tensor
  cores: the scan's recurrence.
* ``bytes``: the bytes at the memory bandwidth.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the full
# power limit of 700 W: TF32 tensor 495 TFLOP/s, float32 outside the
# tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.
PEAK_TENSOR_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def least(tensor_flops: float = 0.0, fp32_flops: float = 0.0,
          nbytes: float = 0.0) -> tuple[float, str]:
    """(least seconds, the bound that sets it)."""
    bounds = {"tensor": tensor_flops / PEAK_TENSOR_TF32,
              "fp32": fp32_flops / PEAK_FP32,
              "bytes": nbytes / PEAK_BYTES}
    by = max(bounds, key=bounds.get)
    return bounds[by], by


def gibbs_flip(N: int, K: int, D: int, k_live: float) -> dict:
    """One sweep of N rows over K columns, k_live of them live, in Gram
    form: P = X Aᵀ over the live columns on the tensor cores (2 N D
    k_live); per live (row, column) the logit and the test (6 operations;
    the carry's move on a flip is data-dependent and left out, so the
    count is a floor). Bytes: X, Z, the uniforms and A read, Z written."""
    return dict(tensor_flops=2.0 * N * D * k_live,
                fp32_flops=6.0 * N * k_live,
                nbytes=F32 * (N * D + 3.0 * N * K + K * D))


def collapsed_scan(rows: int, K: int, D: int, k_live: float) -> dict:
    """One tail scan of ``rows`` rows at K tail columns in the rss form
    with the carried G (the hybrid tail's ``"fast"``), as chip_smoke's
    ``scan_bound_ms`` counts it from the kernel: per row the factor moves
    and G's rank-two moves, rss and H r at the entry and the mean at the
    exit (13 K D + 16 D), and per live column the flip (6 K + 20); all of
    it outside the tensor cores. Bytes: X, the uniforms, two MH draws and
    Z read once, Z and the statistics written once."""
    return dict(fp32_flops=rows * (13.0 * K * D + 16.0 * D
                                   + k_live * (6.0 * K + 20.0)),
                nbytes=F32 * (rows * (D + 2 * K + 2) + rows * K
                              + 2 * (K * K + K * D + 2 * K)))


def feature_stats(N: int, K: int, D: int, k_live: float) -> dict:
    """(ZᵀZ, ZᵀX, m) of N rows: ZᵀZ and ZᵀX over the live columns on the
    tensor cores. Bytes: X and Z read, the statistics written."""
    return dict(tensor_flops=2.0 * N * k_live * (k_live + D),
                fp32_flops=1.0 * N * k_live,
                nbytes=F32 * (N * D + N * K + K * K + K * D + K))


def gaussian_sse(N: int, K: int, D: int, k_live: float) -> dict:
    """‖X − (Z∘active) A‖² of N rows: Z A over the live columns on the
    tensor cores, then subtract, square and add (3 N D). Bytes: X, Z and
    A read."""
    return dict(tensor_flops=2.0 * N * D * k_live,
                fp32_flops=3.0 * N * D,
                nbytes=F32 * (N * D + N * K + K * D + K))


def hybrid_launches(N: int, K_max: int, K_tail: int, D: int, P: int,
                    L: int, k_live: float, tail_live: float,
                    N_eval: int, eval_every: int, eval_sweeps: int = 3
                    ) -> dict[str, list[tuple[float, dict]]]:
    """The kernel launches of one hybrid iteration, as (launches, work of
    one): L sweeps of all N rows, L tail scans of one shard's N/P rows,
    one ``feature_stats`` and one ``gaussian_sse`` in the sync, and the
    eval's sweeps and residual on the held-out rows once every
    ``eval_every`` iterations."""
    e = 1.0 / eval_every
    return {
        "gibbs_flip": [(L, gibbs_flip(N, K_max, D, k_live)),
                       (eval_sweeps * e, gibbs_flip(N_eval, K_max, D,
                                                    k_live))],
        "collapsed_scan": [(L, collapsed_scan(N // P, K_tail, D,
                                              tail_live))],
        "feature_stats": [(1.0, feature_stats(N, K_max, D, k_live))],
        "gaussian_sse": [(1.0, gaussian_sse(N, K_max, D, k_live)),
                         (e, gaussian_sse(N_eval, K_max, D, k_live))],
    }


def uncollapsed_launches(N: int, K: int, D: int
                         ) -> dict[str, list[tuple[float, dict]]]:
    """One serial uncollapsed step: every column live, one sweep, the
    statistics and the residual."""
    return {"gibbs_flip": [(1.0, gibbs_flip(N, K, D, K))],
            "feature_stats": [(1.0, feature_stats(N, K, D, K))],
            "gaussian_sse": [(1.0, gaussian_sse(N, K, D, K))]}


def least_of(launches: list[tuple[float, dict]]) -> float:
    """Summed least seconds of (count, work) launches."""
    return sum(n * least(**w)[0] for n, w in launches)

