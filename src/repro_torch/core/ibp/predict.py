"""Posterior-predictive serving: the sample bank and the batched scorer.

Port of ``repro/core/ibp/predict.py`` (DESIGN.md §15):

* ``SampleBank``: S post-burn-in posterior samples (A, pi, active,
  sigma_x, sigma_a, alpha, chain, it) as tensors with a leading S axis
  on one device, the feature axis packed to the bucket ladder
  (``math.live_buckets``). Each sample's factor chol(Ā Āᵀ + sigma_x² I)
  of the encode warm start is computed once, at harvest, in float64 on
  the host (``BankBuilder.add``), and cached in the bank: the card never
  factorizes. Saved as a self-describing npz (``checkpoint.save_arrays``)
  in the reference's layout, so a bank written by either package loads
  in the other.
* ``encode``: Rao-Blackwellized p(z*_k = 1 | x*, sample) for new rows by
  Gibbs passes over z*; ``exact_posterior`` is the 2^K enumeration
  oracle for small K.
* ``impute``: E[x_miss | x_obs] under the ensemble (masked-Gaussian
  conditioning: only observed dimensions enter the likelihood).
* ``predictive_loglik`` / ``anomaly_score``: the mixture estimator
  log p̂(x*) = logsumexp_s ll_s(x*) − log S.

All four run one scorer, ``_score_bank``, batched over (S samples × B
rows): the bit loop over ``n_sweeps × K`` steps runs in Python, and each
step is one S-batched product and a few elementwise launches over
(S, B), so the launches of a call do not grow with S. The reference
computes this scorer in plain jnp (no Pallas kernel), and so does the
port, in plain PyTorch. The scorer takes its uniforms pre-drawn (``u``),
so the tests feed it the reference's own draws; the public ops draw
them from ``prng.generator(key, device)``.

``make_sharded_scorer`` scores a batch's rows over a mesh axis's ranks
(``parallel.Mesh``): the bank replicated, each rank its block of rows.

``predictive_loglik_naive`` is the un-batched baseline: a Python loop
over the samples, each running ``n_sweeps`` of ``uncollapsed_sweep``
(the ``gibbs_flip`` kernel on the card). ``heldout_joint_loglik`` and
``train_joint_loglik`` are the driver's per-sample metrics;
``joint_loglik_np`` is the float64 numpy test oracle.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import parallel, prng
from repro_torch.checkpoint import load_arrays, save_arrays
from repro_torch.kernels.gaussian_sse import gaussian_sse

from . import math as ibm
from .sweeps import _logit, uncollapsed_sweep

Tensor = torch.Tensor

BANK_FORMAT = 1           # bumped on layout changes; load() checks it
DEFAULT_ENCODE_SWEEPS = 8
DEFAULT_LL_SWEEPS = 3
ENUM_MAX_K = 16           # 2^K patterns: the exact oracle's cap


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


# --------------------------------------------------------------------------
# the bank
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SampleBank:
    """S posterior samples, feature axis packed to the bucket ladder; all
    fields are tensors with a leading S axis on one device. ``chol_f`` is
    each sample's lower Cholesky factor of Ā Āᵀ + sigma_x² I (Ā = A
    masked by ``active``), the ridge map of the encode warm start."""

    A: Tensor        # (S, K, D)   feature weights
    pi: Tensor       # (S, K)      feature probabilities
    active: Tensor   # (S, K)      live-feature mask (float {0,1})
    sigma_x: Tensor  # (S,)
    sigma_a: Tensor  # (S,)
    alpha: Tensor    # (S,)
    chain: Tensor    # (S,) int32  the chain the sample came from
    it: Tensor       # (S,) int32  harvest iteration
    chol_f: Tensor   # (S, K, K)   chol(Ā Āᵀ + sigma_x² I), lower

    @property
    def S(self) -> int:
        return self.A.shape[0]

    @property
    def K(self) -> int:
        return self.A.shape[1]

    @property
    def D(self) -> int:
        return self.A.shape[2]

    def save(self, path: str) -> str:
        arrs = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
        arrs["_format"] = np.asarray(BANK_FORMAT, np.int32)
        return save_arrays(path, arrs)

    @classmethod
    def load(cls, path: str, device: str | torch.device | None = None
             ) -> "SampleBank":
        """The bank saved at ``path``, on ``device`` (default ``cuda``;
        raises without a GPU — pass ``device="cpu"``)."""
        dev = _device.resolve(device)
        arrs = load_arrays(path)
        fmt = int(arrs.pop("_format", 0))
        if fmt != BANK_FORMAT:
            raise ValueError(
                f"sample bank {path} has format {fmt}, expected "
                f"{BANK_FORMAT} — re-harvest with this version"
            )
        names = {f.name for f in dataclasses.fields(cls)}
        missing = names - set(arrs)
        if missing:
            raise ValueError(f"sample bank {path} is missing {sorted(missing)}")
        return cls(**{k: torch.from_numpy(v).to(dev) for k, v in arrs.items()
                      if k in names})


class BankBuilder:
    """Host-side harvest accumulator: keeps each sample's live features
    (canonical order) and packs the bank to the bucket ladder at
    ``build``.

    Each sample's encode factor chol(Ā Āᵀ + sigma_x² I) is computed once,
    at ``add``, on the live block in float64 numpy: the full-width matrix
    is block-diagonal (dead rows of Ā are zero), so ``build`` embeds the
    live block's factor with sigma_x on the dead diagonal and does no
    linear algebra.
    """

    def __init__(self, K_max: int):
        self.K_max = int(K_max)
        self._rows: list[dict] = []

    def __len__(self) -> int:
        return len(self._rows)

    @property
    def max_live(self) -> int:
        return max((r["A"].shape[0] for r in self._rows), default=0)

    def add(self, A, pi, active, sigma_x, sigma_a, alpha,
            chain: int = 0, it: int = 0, chol=None) -> None:
        """One posterior sample in canonical (K_max-padded) layout, as
        numpy arrays or tensors. ``chol`` is the live block's factor
        where the caller has it (``extend_from``: a restart does not
        refactorize)."""
        act = _np(active).astype(np.float32)
        live = np.flatnonzero(act > 0.5)
        A = _np(A).astype(np.float32)
        sx = float(sigma_x)
        if chol is None:
            Al = A[live].astype(np.float64)
            chol = np.linalg.cholesky(Al @ Al.T + sx**2 * np.eye(len(live)))
        self._rows.append({
            "A": A[live],
            "pi": _np(pi).astype(np.float32)[live],
            "chol": _np(chol).astype(np.float32),
            "sigma_x": sx, "sigma_a": float(sigma_a),
            "alpha": float(alpha), "chain": int(chain), "it": int(it),
        })

    def add_state(self, gs, it: int = 0) -> int:
        """Harvest from a ``HybridGlobal`` (chainless, or chain-batched
        with a leading chain axis): one ``.cpu()`` per field, the
        harvest's only host sync. Returns the samples added."""
        A, pi, act, sx, sa, al = (_np(getattr(gs, f)) for f in (
            "A", "pi", "active", "sigma_x", "sigma_a", "alpha"))
        if A.ndim == 3:  # chain-batched
            for c in range(A.shape[0]):
                self.add(A[c], pi[c], act[c], sx[c], sa[c], al[c],
                         chain=c, it=it)
            return A.shape[0]
        self.add(A, pi, act, sx, sa, al, chain=0, it=it)
        return 1

    def extend_from(self, bank: SampleBank) -> int:
        """Re-seed the builder from a saved bank (driver restarts). A built
        bank keeps the live features in the leading slots, so each cached
        factor's live block is its top-left corner."""
        A, pi, act, chol = (_np(getattr(bank, f)) for f in (
            "A", "pi", "active", "chol_f"))
        sx, sa, al, ch, its = (_np(getattr(bank, f)) for f in (
            "sigma_x", "sigma_a", "alpha", "chain", "it"))
        for s in range(bank.S):
            k = int(np.sum(act[s] > 0.5))
            self.add(A[s], pi[s], act[s], sx[s], sa[s], al[s],
                     chain=int(ch[s]), it=int(its[s]), chol=chol[s, :k, :k])
        return bank.S

    def prune_after(self, it: int) -> int:
        """Drop samples harvested after iteration ``it`` (a restore rewinds
        the chain to its checkpoint and re-harvests the iterations since).
        Returns the number dropped."""
        n0 = len(self._rows)
        self._rows = [r for r in self._rows if r["it"] <= it]
        return n0 - len(self._rows)

    def build(self, device: str | torch.device | None = None) -> SampleBank:
        """The bank on ``device`` (default ``cuda``)."""
        if not self._rows:
            raise ValueError("empty bank: no samples harvested (is "
                             "harvest_every set and past harvest_burn?)")
        dev = _device.resolve(device)
        B = ibm.pick_bucket(ibm.live_buckets(self.K_max), self.max_live, 0)
        S = len(self._rows)
        D = self._rows[0]["A"].shape[1]
        A = np.zeros((S, B, D), np.float32)
        pi = np.zeros((S, B), np.float32)
        act = np.zeros((S, B), np.float32)
        chol = np.zeros((S, B, B), np.float32)
        for s, r in enumerate(self._rows):
            k = r["A"].shape[0]
            A[s, :k] = r["A"]
            pi[s, :k] = r["pi"]
            act[s, :k] = 1.0
            chol[s, :k, :k] = r["chol"]
            chol[s, range(k, B), range(k, B)] = r["sigma_x"]

        def col(name, dt):
            return np.asarray([r[name] for r in self._rows], dtype=dt)

        arrs = dict(A=A, pi=pi, active=act,
                    sigma_x=col("sigma_x", np.float32),
                    sigma_a=col("sigma_a", np.float32),
                    alpha=col("alpha", np.float32),
                    chain=col("chain", np.int32), it=col("it", np.int32),
                    chol_f=chol)
        return SampleBank(**{k: torch.from_numpy(v).to(dev)
                             for k, v in arrs.items()})


# --------------------------------------------------------------------------
# the scorer: masked Rao-Blackwellized Gibbs over z*, batched over S
# --------------------------------------------------------------------------


def _score_bank(bank: SampleBank, X: Tensor, mask: Tensor | None, u: Tensor,
                n_sweeps: int, rb_from: int
                ) -> tuple[Tensor, Tensor, Tensor]:
    """Gibbs over z for B rows under each of the S samples at once.

    X (B, D) and ``mask`` (B, D; None = all observed) on the bank's
    device; ``u`` (S, n_sweeps, K, B) uniforms. Returns (probs (S, B, K),
    Z (S, B, K), rows_ll (S, B)): ``probs`` averages each bit's
    conditional p(z_k = 1 | z_-k, x_obs) over sweeps ``rb_from ..
    n_sweeps-1``, ``Z`` is the last draw, ``rows_ll`` each row's joint
    log p(x_obs, z | sample).

    Only observed dimensions enter: the carried residual R is masked and
    the bit's |a_k|² is the masked norm, one (A∘A) @ maskᵀ product up
    front. The chain starts from the ridge map z0 = 1[F⁻¹ Ā x_obs > 1/2],
    solved on the cached factor. A bit step reads R·a_k (one S-batched
    product) and moves R by the bit's change; Z is written in place, row
    k of the carried Zᵀ. Rows are independent chains.
    """
    S, K, _ = bank.A.shape
    masked = mask is not None
    A, active = bank.A, bank.active
    Am = A * active[:, :, None]
    Xm = X * mask if masked else X
    y = torch.cholesky_solve(Am @ Xm.T, bank.chol_f)        # (S, K, B)
    Zt = ((y > 0.5).to(X.dtype) * active[:, :, None]).transpose(0, 1)
    Zt = Zt.contiguous()                                    # (K, S, B)
    ZA = Zt.permute(1, 2, 0) @ Am                           # (S, B, D)
    R = Xm - ZA * mask if masked else Xm - ZA
    # the per-bit operands, feature-major so that each step reads a
    # contiguous slice
    At = A.transpose(0, 1).contiguous()                     # (K, S, D)
    an = ((A * A) @ mask.T if masked                        # (S, K, B)
          else (A * A).sum(-1, keepdim=True))               # (S, K, 1)
    an = an.transpose(0, 1).contiguous()
    lpi = _logit(bank.pi).T.contiguous()[:, :, None]        # (K, S, 1)
    act = active.T.contiguous()[:, :, None]                 # (K, S, 1)
    live = act > 0
    inv2s2 = (0.5 / bank.sigma_x**2)[:, None]               # (S, 1)
    ul = _logit(torch.clamp(u, 1e-7, 1.0 - 1e-7))
    ul = ul.permute(1, 2, 0, 3).contiguous()                # (n_sw, K, S, B)
    w = 1.0 / max(n_sweeps - rb_from, 1)
    probs = torch.zeros_like(Zt)
    for sweep in range(n_sweeps):
        for k in range(K):
            a_k, z_k = At[k], Zt[k]
            # R0·(a_k ∘ mask) = R·a_k + z_k ‖a_k‖²_obs (R is masked)
            ra = torch.bmm(R, a_k[:, :, None])[:, :, 0]
            logits = lpi[k] + (2.0 * torch.addcmul(ra, z_k, an[k])
                               - an[k]) * inv2s2
            znew = torch.where(live[k], logits > ul[sweep, k],
                               z_k > 0.5).to(X.dtype)
            if sweep >= rb_from:
                probs[k].addcmul_(torch.sigmoid(logits), act[k], value=w)
            delta = znew - z_k
            if masked:
                R.addcmul_(delta[:, :, None] * mask, a_k[:, None, :],
                           value=-1.0)
            else:
                R.baddbmm_(delta[:, :, None], a_k[:, None, :], alpha=-1.0)
            z_k.copy_(znew)
    Z = Zt.permute(1, 2, 0)
    lls = _rows_joint_loglik(A, bank.pi, active, bank.sigma_x, X, Z, mask)
    return probs.permute(1, 2, 0), Z, lls


def _rows_joint_loglik(A: Tensor, pi: Tensor, active: Tensor,
                       sigma_x: Tensor, X: Tensor, Z: Tensor,
                       mask: Tensor | None = None) -> Tensor:
    """Per-row joint log p(x_obs, z | sample): (S, B) for a bank's leading
    S axis (A (S, K, D), Z (S, B, K)), (B,) for one sample."""
    Am = A * active[..., :, None]
    R = X - Z @ Am
    if mask is None:
        n_obs = float(X.shape[-1])
    else:
        R = R * mask
        n_obs = mask.sum(-1)
    sx = sigma_x[..., None]
    ll = (-0.5 * n_obs * ibm.LOG2PI - n_obs * torch.log(sx)
          - 0.5 * (R * R).sum(-1) / sx**2)
    p = torch.clamp(pi, 1e-6, 1.0 - 1e-6)[..., None, :]
    lz = Z * torch.log(p) + (1.0 - Z) * torch.log1p(-p)
    return ll + (lz * active[..., None, :]).sum(-1)


def _as_rows(bank: SampleBank, X) -> Tensor:
    return torch.as_tensor(X, dtype=bank.A.dtype, device=bank.A.device)


def _as_mask(X: Tensor, mask) -> Tensor | None:
    return None if mask is None else torch.as_tensor(mask, dtype=X.dtype,
                                                     device=X.device)


def _score(bank: SampleBank, X: Tensor, mask: Tensor | None, key: Tensor,
           n_sweeps: int) -> tuple[Tensor, Tensor, Tensor]:
    """``_score_bank`` on uniforms drawn from ``key`` on the bank's
    device, Rao-Blackwellized over the second half of the sweeps."""
    g = prng.generator(key, X.device)
    u = torch.rand((bank.S, n_sweeps, bank.K, X.shape[0]), generator=g,
                   dtype=X.dtype, device=X.device)
    return _score_bank(bank, X, mask, u, n_sweeps, n_sweeps // 2)


# --------------------------------------------------------------------------
# public predictive ops
# --------------------------------------------------------------------------


def encode(bank: SampleBank, X, key: Tensor, *, mask=None,
           n_sweeps: int = DEFAULT_ENCODE_SWEEPS,
           return_draws: bool = False):
    """Rao-Blackwellized p(z*_k = 1 | x*, sample) for new rows: (S, B, K),
    one slice per bank sample; with ``return_draws`` also the last Gibbs
    draws (S, B, K). ``mask`` (B, D) marks observed dimensions (None =
    all)."""
    X = _as_rows(bank, X)
    probs, Z, _ = _score(bank, X, _as_mask(X, mask), key, n_sweeps)
    return (probs, Z) if return_draws else probs


def impute(bank: SampleBank, X, mask, key: Tensor, *,
           n_sweeps: int = DEFAULT_ENCODE_SWEEPS) -> Tensor:
    """E[x | x_obs] under the ensemble, (B, D); observed entries pass
    through. By linearity E[x_miss | x_obs, s] = E[z | x_obs, s] @ A_s,
    and the RB probabilities estimate E[z | x_obs, s]; the ensemble is
    the mean over samples."""
    X = _as_rows(bank, X)
    m = _as_mask(X, mask)
    if m is None:  # every entry observed: nothing to impute
        return X.clone()
    probs, _, _ = _score(bank, X, m, key, n_sweeps)
    recon = (probs @ (bank.A * bank.active[:, :, None])).mean(0)
    return m * X + (1.0 - m) * recon


def predictive_loglik(bank: SampleBank, X, key: Tensor, *, mask=None,
                      n_sweeps: int = DEFAULT_LL_SWEEPS,
                      per_sample: bool = False):
    """The mixture estimator log p̂(x*_b) = logsumexp_s ll_sb − log S, (B,),
    ll_sb the per-sample joint log-likelihood with z* imputed by the
    Gibbs pass (the paper's Fig. 1 metric, row by row). ``per_sample``
    also returns the (S, B) rows."""
    X = _as_rows(bank, X)
    _, _, lls = _score(bank, X, _as_mask(X, mask), key, n_sweeps)
    mix = torch.logsumexp(lls, 0) - math.log(lls.shape[0])
    return (mix, lls) if per_sample else mix


def anomaly_score(bank: SampleBank, X, key: Tensor, *, mask=None,
                  n_sweeps: int = DEFAULT_LL_SWEEPS) -> Tensor:
    """Per-row anomaly score: − the mixture predictive log-likelihood."""
    return -predictive_loglik(bank, X, key, mask=mask, n_sweeps=n_sweeps)


def make_sharded_scorer(bank: SampleBank, mesh: parallel.Mesh, *,
                        axis: str = "data",
                        n_sweeps: int = DEFAULT_LL_SWEEPS):
    """Row-sharded mixture scoring over the mesh ``axis``'s ranks, the
    serving counterpart of the sampler's data axis: the bank is
    replicated, rank i of the axis (``mesh.axis_index(axis)``) scores
    rows [i·B/n, (i+1)·B/n) of the batch with
    ``predictive_loglik(bank, X_i, fold_in(key, i), n_sweeps=)``, so the
    ranks draw independent Gibbs streams, and the blocks are gathered
    over the axis's group.

    Returns ``score(X, key) -> (B,)``, the whole batch's scores on every
    rank of the axis (each calls it with the same X and key). B must be
    a multiple of the axis size n (``ValueError`` otherwise)."""
    i, n = mesh.axis_index(axis), mesh.axis_size(axis)
    group = mesh.group(axis)

    def score(X, key: Tensor) -> Tensor:
        X = _as_rows(bank, X)
        B = X.shape[0]
        if B % n:
            raise ValueError(f"make_sharded_scorer: B={B} rows do not "
                             f"split over the {n} ranks of axis {axis!r}")
        b = B // n
        ll = predictive_loglik(bank, X[i * b:(i + 1) * b],
                               prng.fold_in(key, i), n_sweeps=n_sweeps)
        return parallel.all_gather_rows(ll, group=group)

    return score


def _naive_sample_rows(A: Tensor, pi: Tensor, active: Tensor,
                       sigma_x: Tensor, X: Tensor, key: Tensor,
                       n_sweeps: int) -> Tensor:
    """Per-row joint ll for one sample the way before the bank: Gibbs
    imputation of z* from Z = 0 by ``n_sweeps`` of ``uncollapsed_sweep``
    (``heldout_joint_loglik``'s inner loop), then the row-decomposed
    joint."""
    Z = X.new_zeros((X.shape[0], A.shape[0]))
    for l in range(n_sweeps):
        Z = uncollapsed_sweep(X, Z, A, pi, active, sigma_x,
                              prng.generator(prng.fold_in(key, l), X.device))
    return _rows_joint_loglik(A, pi, active, sigma_x, X, Z)


def predictive_loglik_naive(bank: SampleBank, X, key: Tensor, *,
                            n_sweeps: int = DEFAULT_LL_SWEEPS) -> Tensor:
    """The un-batched baseline: a Python loop over the bank's samples,
    each scored by ``_naive_sample_rows`` (S × n_sweeps sweeps), mixed
    as ``predictive_loglik`` mixes."""
    X = _as_rows(bank, X)
    keys = prng.split(key, bank.S)
    lls = torch.stack([
        _naive_sample_rows(bank.A[s], bank.pi[s], bank.active[s],
                           bank.sigma_x[s], X, keys[s], n_sweeps)
        for s in range(bank.S)])
    return torch.logsumexp(lls, 0) - math.log(bank.S)


# --------------------------------------------------------------------------
# exact small-K enumeration oracle
# --------------------------------------------------------------------------


def exact_posterior(A, pi, active, sigma_x, X, mask=None
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """Exact p(z* | x*_obs) by 2^K enumeration (K ≤ ENUM_MAX_K), on the
    device of ``A`` (numpy input: the CPU).

    Returns (marginals (B, K), log_marginal_lik (B,), cond_mean (B, D)),
    the targets ``encode`` / ``predictive_loglik`` / ``impute`` estimate.
    Patterns that set an inactive bit get weight −inf. Holds a
    (2^K, B, D) temporary."""
    A = torch.as_tensor(A)
    K, D = A.shape
    if K > ENUM_MAX_K:
        raise ValueError(f"exact enumeration needs K <= {ENUM_MAX_K}, "
                         f"got {K}")

    def t(v):
        return torch.as_tensor(v, dtype=A.dtype, device=A.device)

    pi, active, sigma_x, X = t(pi), t(active), t(sigma_x), t(X)
    m = torch.ones_like(X) if mask is None else t(mask)
    bits = torch.arange(K, device=A.device)
    pats = ((torch.arange(2**K, device=A.device)[:, None] >> bits[None, :])
            & 1).to(A.dtype)                                    # (P, K)
    valid = torch.all(pats <= active[None, :] + 0.5, dim=1)
    p = torch.clamp(pi, 1e-6, 1.0 - 1e-6)
    prior = ((pats * torch.log(p)[None, :]
              + (1.0 - pats) * torch.log1p(-p)[None, :])
             * active[None, :]).sum(1)                          # (P,)
    means = pats @ (A * active[:, None])                        # (P, D)
    R = X[None, :, :] - means[:, None, :]                       # (P, B, D)
    sse = (R * R * m[None, :, :]).sum(-1)                       # (P, B)
    n_obs = m.sum(-1)[None, :]
    ll = (-0.5 * n_obs * ibm.LOG2PI - n_obs * torch.log(sigma_x)
          - 0.5 * sse / sigma_x**2)
    logw = torch.where(valid[:, None], prior[:, None] + ll,
                       torch.tensor(-math.inf, dtype=A.dtype,
                                    device=A.device))
    logZ = torch.logsumexp(logw, 0)                             # (B,)
    w = torch.exp(logw - logZ[None, :])                         # (P, B)
    return w.T @ pats, logZ, w.T @ means


# --------------------------------------------------------------------------
# per-sample joint log-likelihoods of the driver's eval records
# --------------------------------------------------------------------------


def heldout_joint_loglik(X_test: Tensor, A: Tensor, pi: Tensor,
                         active: Tensor, sigma_x: Tensor, key: Tensor,
                         n_sweeps: int = DEFAULT_LL_SWEEPS) -> Tensor:
    """log P(X_test, Z_test | A, pi, sigma) with Z_test imputed by short
    uncollapsed Gibbs given ONE posterior draw (paper Fig. 1 metric).
    The residual is scored by the ``gaussian_sse`` kernel."""
    N = X_test.shape[0]
    Z = torch.zeros((N, A.shape[0]), dtype=X_test.dtype, device=X_test.device)
    for l in range(n_sweeps):
        Z = uncollapsed_sweep(X_test, Z, A, pi, active, sigma_x,
                              prng.generator(prng.fold_in(key, l),
                                             X_test.device))
    n = X_test.numel()
    sse = gaussian_sse(X_test, Z, A, active)
    ll = (-0.5 * n * ibm.LOG2PI - n * torch.log(sigma_x)
          - 0.5 * sse / sigma_x**2)
    return ll + ibm.z_prior_loglik(Z, pi, active)


def train_joint_loglik(X: Tensor, Z: Tensor, A: Tensor, pi: Tensor,
                       active: Tensor, sigma_x: Tensor) -> Tensor:
    """log P(X, Z | A, pi, sigma) on the training rows (monitoring)."""
    ll = ibm.uncollapsed_loglik(X, Z * active[None, :], A, sigma_x)
    return ll + ibm.z_prior_loglik(Z, pi, active)


# --------------------------------------------------------------------------
# numpy test oracle (not a production path)
# --------------------------------------------------------------------------


def joint_loglik_np(X, Z, A, pi, active, sigma_x, mask=None) -> np.ndarray:
    """Per-row joint log p(x_obs, z | sample) as an explicit float64
    numpy loop: the oracle ``_rows_joint_loglik`` is held against. Kept
    deliberately naive."""
    X = np.asarray(_np(X), np.float64)
    Z = np.asarray(_np(Z), np.float64)
    A = np.asarray(_np(A), np.float64)
    pi = np.asarray(_np(pi), np.float64)
    active = np.asarray(_np(active), np.float64)
    sx = float(sigma_x)
    m = (np.ones_like(X) if mask is None
         else np.asarray(_np(mask), np.float64))
    B, D = X.shape
    out = np.zeros((B,), np.float64)
    log2pi = float(np.log(2.0 * np.pi))
    for b in range(B):
        ll = 0.0
        for d in range(D):
            if m[b, d] > 0.5:
                r = X[b, d] - float(
                    sum(Z[b, k] * active[k] * A[k, d]
                        for k in range(A.shape[0])))
                ll += -0.5 * log2pi - np.log(sx) - 0.5 * r * r / sx**2
        for k in range(A.shape[0]):
            if active[k] > 0.5:
                p = min(max(pi[k], 1e-6), 1.0 - 1e-6)
                ll += (Z[b, k] * np.log(p)
                       + (1.0 - Z[b, k]) * np.log1p(-p))
        out[b] = ll
    return out
