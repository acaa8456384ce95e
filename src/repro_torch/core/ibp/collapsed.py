"""The collapsed row scan of the hybrid sampler's tail.

Port of what ``repro/core/ibp/collapsed.py`` runs for the hybrid tail:
``collapsed_row_scan(..., birth="mh", backend="pallas")``, the
reference's ``_packed_scan`` at the full-width block. The row step, the
carried factor, the refresh and drift probe and the MH births are
documented beside the plain version, ``kernels/collapsed_scan/ref.py``.

On a CUDA tensor the whole scan is one launch of the ``collapsed_scan``
kernel: one block walks every row with the carry on chip and every
branch of the row step decided on the device, so a scan costs no host
sync and the rows' bit flips run the ``collapsed_row`` recurrence inside
it. On a CPU tensor the scan is the plain version, a Python loop that
reads its branch flags on the host. The tail's Z, mask and statistics
are updated in place on copies of the caller's.

Draws: the scan's randomness is drawn up front (``draw_scan``), as the
reference hoists it, and passed in, so a test can feed the port the
reference's own draws.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.collapsed_scan import collapsed_scan

Tensor = torch.Tensor

DEFAULT_REFRESH = 64      # exact refactorization cadence
DEFAULT_DRIFT_TOL = 1e-2  # probe-residual threshold forcing an early refresh


@dataclasses.dataclass
class ScanDraws:
    """The row scan's random numbers, one row of each per scanned row."""

    u_logit: Tensor    # (n_rows, K) logit-uniform bit-flip thresholds
    j_prop: Tensor     # (n_rows,) MH birth proposals, Poisson(alpha/N)
    log_u_acc: Tensor  # (n_rows,) log of the MH accept uniforms


def draw_scan(n_rows: int, K: int, alpha: Tensor, N: float,
              gen: torch.Generator) -> ScanDraws:
    """Draw a scan's randomness on ``alpha``'s device from ``gen``."""
    dev, dt = alpha.device, alpha.dtype
    uu = torch.rand((n_rows, K), generator=gen, dtype=dt, device=dev)
    uu = torch.clamp(uu, 1e-7, 1.0 - 1e-7)
    lam = (alpha / N) * torch.ones((n_rows,), dtype=dt, device=dev)
    return ScanDraws(
        u_logit=torch.log(uu) - torch.log1p(-uu),
        j_prop=torch.poisson(lam, generator=gen),
        log_u_acc=torch.log(torch.rand((n_rows,), generator=gen, dtype=dt,
                                       device=dev)),
    )


def collapsed_row_scan(
    Z: Tensor,
    active: Tensor,
    ZtZ: Tensor,
    ZtX: Tensor,
    m: Tensor,
    X: Tensor,
    sx: Tensor,
    sa: Tensor,
    draws: ScanDraws,
    *,
    N: float,
    refresh_every: int = DEFAULT_REFRESH,
    drift_tol: float = DEFAULT_DRIFT_TOL,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Scan the collapsed row step (MH births) over every row of ``X``.

    ``N`` is the GLOBAL observation count: the tail runs on one shard's
    rows with global-N priors ((m_k - Z_nk)/N and Poisson(alpha/N)).
    Returns (Z, active, ZtZ, ZtX, m, n_refresh, n_sat): ``n_refresh``
    counts exact refactorizations and ``n_sat`` the capacity-vetoed
    accepted births, both int32 device scalars.
    """
    Z, active, ZtZ, ZtX, m = (t.clone(memory_format=torch.contiguous_format)
                              for t in (Z, active, ZtZ, ZtX, m))
    counts = collapsed_scan(Z, active, ZtZ, ZtX, m, X, draws.u_logit,
                            draws.j_prop, draws.log_u_acc, sx, sa, N=N,
                            refresh_every=refresh_every, drift_tol=drift_tol)
    return Z, active, ZtZ, ZtX, m, counts[0], counts[1]
