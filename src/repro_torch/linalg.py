"""Dense linear algebra of the collapsed factor: the padded W, its
Cholesky inverse and the rank-one Cholesky moves.

Port of those helpers of ``repro/core/ibp/math.py``; ``core/ibp/math.py``
re-exports them under the reference's names. They sit outside
``core/ibp`` so that the tail scan's plain version
(``kernels/collapsed_scan/ref.py``) can use them without importing the
sampler package that calls the kernel.

Feature-indexed buffers are padded to a static ``K_max``; an ``active``
mask (float {0,1}) selects live columns. The padded W has unit diagonal
and zero off-diagonal in inactive slots, so its Cholesky factor and
log-determinant are exact on the active block.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def mask_outer(active: Tensor) -> Tensor:
    """(K,K) mask with 1 where both row & col active."""
    return active[:, None] * active[None, :]


def _eye(K: int, like: Tensor) -> Tensor:
    return torch.eye(K, dtype=like.dtype, device=like.device)


def padded_W(ZtZ: Tensor, active: Tensor, ratio: Tensor) -> Tensor:
    """W = ZtZ + ratio*I on the active block; identity on the inactive one.

    ratio = sigma_x^2 / sigma_a^2.
    """
    K = ZtZ.shape[0]
    eye = _eye(K, ZtZ)
    m2 = mask_outer(active)
    W = ZtZ * m2 + ratio * eye * m2
    return W + eye * (1.0 - active)


def _cholesky(W: Tensor) -> Tensor:
    # cholesky_ex: no host sync for the error check (W is SPD by
    # construction; the reference does not check either)
    return torch.linalg.cholesky_ex(W).L


def chol_inv_logdet(W: Tensor) -> tuple[Tensor, Tensor]:
    """Return (W^{-1}, logdet W) via Cholesky. W must be SPD."""
    L = _cholesky(W)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    Linv = torch.linalg.solve_triangular(L, _eye(W.shape[0], W), upper=False)
    return Linv.T @ Linv, logdet


def chol_inv(W: Tensor) -> tuple[Tensor, Tensor]:
    """Return (L, W^{-1}) via Cholesky — the exact refactorization the
    collapsed row scan refreshes its carried (L, M) from."""
    L = _cholesky(W)
    Linv = torch.linalg.solve_triangular(L, _eye(W.shape[0], W), upper=False)
    return L, Linv.T @ Linv


def _chol_rank1_t(Lt: Tensor, p: Tensor, sigma: float,
                  eps: float) -> tuple[Tensor, Tensor]:
    """Rank-one Cholesky up/downdate in the transposed layout.

    Closed semiseparable form (Gill, Golub, Murray & Saunders Method C):
    with p = L^{-1} x, chol(L L^T + sigma x x^T) = L chol(I + sigma p p^T),
    and chol(I + sigma p p^T) has T[j,j] = sqrt(d_j / d_{j-1}),
    T[i>j, j] = sigma p_i p_j / sqrt(d_j d_{j-1}), d_j = 1 + sigma
    cumsum(p^2)_j. Works on Lt = L^T (upper triangular, row-major):
    (L T)^T[j] = r_j Lt[j] + qc_j * sum_{i>j} p_i Lt[i].

    Returns (Lt', ok); ``ok`` is False when some d_j fell below ``eps``
    (the downdated matrix lost positive definiteness).

    Padding contract: an inactive slot j has Lt[j, j] = 1, zero
    off-diagonals and p_j = 0, so its row scales by exactly 1 and
    receives exactly 0.
    """
    K = Lt.shape[0]
    p2 = p * p
    d = 1.0 + sigma * torch.cumsum(p2, 0)
    d_prev = d - sigma * p2  # d_{j-1} with d_{-1} = 1
    ok = torch.all(d > eps) & torch.all(d_prev > eps)
    d = torch.clamp(d, min=eps)
    d_prev = torch.clamp(d_prev, min=eps)
    r = torch.sqrt(d / d_prev)
    qc = sigma * p / torch.sqrt(d * d_prev)
    Gt = Lt * p[:, None]
    # exclusive tail sums over rows, as the reference computes them: a
    # product with a lower-triangular ones matrix
    tril = torch.tril(torch.ones((K, K), dtype=Lt.dtype, device=Lt.device))
    acc = tril @ Gt
    Ct = acc[-1][None, :] - acc
    return Lt * r[:, None] + Ct * qc[:, None], ok


def chol_rank1_update_t(Lt: Tensor, p: Tensor) -> Tensor:
    """Transposed-layout rank-one update with precomputed p = L^{-1} x."""
    Lp, _ = _chol_rank1_t(Lt, p, 1.0, 1e-12)
    return Lp


def chol_rank1_downdate_t(Lt: Tensor, p: Tensor,
                          eps: float = 1e-12) -> tuple[Tensor, Tensor]:
    """Transposed-layout rank-one downdate with precomputed p = L^{-1} x.
    Returns (Lt', ok)."""
    return _chol_rank1_t(Lt, p, -1.0, eps)


def chol_rank1_update(L: Tensor, x: Tensor) -> Tensor:
    """Rank-one Cholesky update: chol(L L^T + x x^T) for a lower L.

    The standalone form: solves for p = L^{-1} x itself. See
    ``_chol_rank1_t`` for the algebra and the padding contract.
    """
    p = torch.linalg.solve_triangular(L, x[:, None], upper=False)[:, 0]
    return chol_rank1_update_t(L.T, p).T


def chol_rank1_downdate(L: Tensor, x: Tensor,
                        eps: float = 1e-12) -> tuple[Tensor, Tensor]:
    """Rank-one Cholesky downdate: chol(L L^T - x x^T) for a lower L.

    Returns (L', ok); ``ok`` is False when the downdated matrix lost
    positive definiteness (a float-drift canary: removing a row from W
    keeps it SPD in exact arithmetic).
    """
    p = torch.linalg.solve_triangular(L, x[:, None], upper=False)[:, 0]
    Lt, ok = chol_rank1_downdate_t(L.T, p, eps)
    return Lt.T, ok


def g_rank1(G: Tensor, H: Tensor, a: Tensor, b: Tensor,
            hb: Tensor | None = None, bb: Tensor | None = None) -> Tensor:
    """Move G = H Hᵀ through the rank-one map move H' = H + a bᵀ.

    G' = G + a(Hb)ᵀ + (Hb)aᵀ + (b·b) a aᵀ, a symmetric rank-two
    correction costing O(K² + KD) instead of the O(K²D) recompute.
    ``H`` is the PRE-move map. Evaluated as a cᵀ + c aᵀ with c = Hb +
    (b·b)/2 · a, so the result is exactly symmetric whenever G is
    (a_i c_j + c_i a_j is commutative in float): the rss flip reads rows
    of G as columns. A padded slot j has H[j] = 0 and a_j = 0, so row and
    column j of every correction term are exactly 0. ``hb`` = H b and
    ``bb`` = b·b, where the caller has them, are used as given.
    """
    hb = H @ b if hb is None else hb
    bb = torch.dot(b, b) if bb is None else bb
    c = hb + (0.5 * bb) * a
    return G + (torch.outer(a, c) + torch.outer(c, a))


def block_select(active: Tensor, B: int) -> tuple[Tensor, Tensor]:
    """Canonical columns of the packed block of ``B`` columns, ascending:
    every live column plus the lowest-index free slots, so that visiting
    the block in order visits live columns in canonical order, and a
    birth placed in the block's first free slots lands where the
    canonical first-free-slot rule puts it as long as it stays below
    ``min_out``, the smallest out-of-block index (every out-of-block slot
    is free). Needs sum(active) <= B. Returns (cols (B,) int64, min_out
    () int64, K when the block covers every column), both on
    ``active``'s device and with no host sync.
    """
    K = active.shape[0]
    free = 1.0 - active
    free_rank = torch.cumsum(free, 0) * free
    n_live = torch.sum(active)
    sel = (active > 0.5) | ((free_rank >= 1.0) & (free_rank <= B - n_live))
    # the selected indices first, each group in ascending order
    cols = torch.argsort((~sel).to(torch.int8), stable=True)[:B]
    idx = torch.arange(K, device=active.device)
    min_out = torch.min(torch.where(sel, K, idx))
    return cols, min_out
