"""The numbers that decide ``correct``, each held to its limit.

A judged step is what one side produced from the state before it (the
program's, or the TF32 control's): each sweep's result, each tail
scan's result, and the iteration's Z, A, π, live mask, σ_x, σ_a, α,
next key and p′, and the eval record's log-likelihoods. Each stage is
judged against the float64 reference from that side's own inputs, with
the same random numbers, so a fault shows in the stage that made it:

* ``decision_margin``: over the step's sweeps and (hybrid) its tail
  scans, the widest margin |log-odds − logit(u)| of a decision the side
  took otherwise than the reference, each decision taken in the state
  its sweep or scan was in (0 when all agree; rounding can only flip a
  decision of a small margin). A birth in the wrong columns or of the
  wrong count, or stages that do not chain, read infinite;
* ``stage_chain`` (hybrid): exact, limit 0 — entries where the recorded
  stages do not chain from the step's input to its output
  (``stage_chain``); infinite when a sweep or a scan is missing;
* ``sync_gap``: the widest gap of the sync's draws against the
  reference's from the step's own Z — A's rows (over the larger of the
  row's norm and the median live row's), π (absolute), σ_x, σ_a and α
  (relative) — and (hybrid) of the last eval record's training and
  held-out log-likelihoods (relative), the held-out one with its sweeps;
* ``live_mask``, ``keys``: exact, limit 0 — columns whose live flag
  disagrees with their count, and the next key, p′ and iteration that
  differ from the reference's.
"""
from __future__ import annotations

import json
import math
import os

import torch

from . import keys, reference as ref

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(workload: str) -> dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as fh:
        return json.load(fh)["limits"]


def held(numbers: dict[str, float], limits: dict[str, float]
         ) -> tuple[bool, list[list]]:
    """(every number within its limit, [[name, number, limit], ...]). A
    number that is not finite fails; a number without a limit fails."""
    rows, ok = [], True
    for name, v in numbers.items():
        lim = limits.get(name)
        good = lim is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        rows.append([name, v, lim])
    return ok, rows


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


def _a_gap(A: torch.Tensor, A_ref: torch.Tensor, live: torch.Tensor
           ) -> float:
    d = torch.linalg.vector_norm(A.double() - A_ref.double(), dim=1)
    n = torch.linalg.vector_norm(A_ref.double(), dim=1)
    med = float(torch.median(n[live])) if bool(live.any()) else 1.0
    return float(torch.max(d / torch.clamp(n, min=med)))


def _draws(side: dict, want: dict, live: torch.Tensor) -> float:
    return max(_a_gap(side["A"], want["A"], live),
               float(torch.max(torch.abs(side["pi"].double()
                                         - want["pi"].double()))),
               _rel(side["sigma_x"], want["sigma_x"]),
               _rel(side["sigma_a"], want["sigma_a"]),
               _rel(side["alpha"], want["alpha"]))


def margin(d: torch.Tensor, bits: torch.Tensor) -> float:
    """The widest |d| of a decision (d not NaN) that ``bits`` takes
    otherwise than d > 0; 0 when all agree."""
    dec = ~torch.isnan(d)
    off = dec & ((d > 0) != (bits > 0.5))
    return float(torch.max(torch.abs(d[off]))) if bool(off.any()) else 0.0


def _forced_bits(d: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """A side's decisions taken as d > 0 where d decides, else kept."""
    return torch.where(torch.isnan(d), fallback, (d > 0).to(fallback.dtype))


def sweep_margins(X, pre: dict, sweeps: list, uniforms: list,
                  control: bool = False) -> float:
    """``decision_margin`` over the step's sweeps [(Z_in, Z_out), ...]: the
    program's results, or with ``control`` the TF32 reference's
    decisions in their place."""
    out = 0.0
    for (Z_in, Z_out), u in zip(sweeps, uniforms, strict=True):
        d = ref.sweep_forced(X, Z_in, Z_out, pre["A"], pre["pi"],
                             pre["active"], pre["sigma_x"], u)
        bits = Z_out
        if control:
            bits = _forced_bits(ref.sweep_forced(
                X, Z_in, Z_out, pre["A"], pre["pi"], pre["active"],
                pre["sigma_x"], u, prec="tf32"), Z_in)
        out = max(out, margin(d, bits))
        del d
    return out


def tail_margins(X, pre: dict, sweeps: list, tails: list, P: int,
                 control: bool = False) -> float:
    """``decision_margin`` over the step's tail scans [(tail in, tail out,
    live out), ...]: scan l on the residual of p′'s rows after sweep l."""
    pp = pre["p_prime"]
    N = X.shape[0]
    N_p = N // P
    rows = slice(pp * N_p, (pp + 1) * N_p)
    Xp = X[rows].double()
    act = pre["active"].double()
    out = 0.0
    for l, ((_, Z), (Z_in, Z_out, _)) in enumerate(zip(sweeps, tails,
                                                        strict=True)):
        R = Xp - (Z[rows].double() * act[None, :]) @ pre["A"].double()
        draws = ref.tail_draws(pre["key"], pp, l, N_p, Z_in.shape[1],
                               pre["alpha"], float(N), X.device)
        d_f, d_b, ok = ref.tail_forced(R, Z_in, Z_out, pre["sigma_x"],
                                       pre["sigma_a"], float(N), *draws)
        flips = Z_out.double()
        # a row's births are its new columns: set, and not its decisions
        acc = ((Z_out.double() * torch.isnan(d_f)).sum(1) > 0).double()
        if control:
            c_f, c_b, _ = ref.tail_forced(R, Z_in, Z_out, pre["sigma_x"],
                                          pre["sigma_a"], float(N), *draws,
                                          prec="tf32")
            flips = _forced_bits(c_f, flips)
            acc = (c_b > 0).double()
            ok = torch.ones_like(ok)
        if not bool(ok.all()):
            return math.inf
        out = max(out, margin(d_f, flips), margin(d_b, acc))
    return out


def _pruned(Z_t: torch.Tensor, live_t: torch.Tensor) -> torch.Tensor:
    """A tail scan's result as the next stage takes it: the columns left
    without rows dropped."""
    return Z_t * ((live_t > 0.5) & (Z_t.sum(0) > 0.5)).to(Z_t.dtype)


def stage_chain(pre: dict, side: dict, sweeps: list, tails: list, P: int,
                L: int) -> float:
    """Entries where the recorded stages do not chain from the step's
    input to its output: the first sweep's Z in is not the state's Z,
    sweep l's is not sweep l − 1's result, the first tail scan's input
    is not p′'s tail in the state, scan l's is not scan l − 1's result,
    or the step's Z is not the last sweep's on the live columns with the
    last scan's live columns promoted, in order, into the first free
    columns of p′'s rows (and 0 elsewhere). Infinite unless there are L
    sweeps and L scans."""
    if len(sweeps) != L or len(tails) != L:
        return math.inf

    def off(a, b) -> float:
        if a.shape != b.shape:
            return math.inf
        return float((a != b).sum())

    n = off(sweeps[0][0], pre["Z"]) + off(tails[0][0], pre["Z_tail"])
    for l in range(1, L):
        n += off(sweeps[l][0], sweeps[l - 1][1])
        n += off(tails[l][0], _pruned(*tails[l - 1][1:]))
    old = pre["active"] > 0.5
    want = sweeps[-1][1] * old.to(sweeps[-1][1].dtype)[None, :]
    Z_t = _pruned(*tails[-1][1:])
    cols = torch.nonzero(Z_t.sum(0) > 0.5).flatten()
    free = torch.nonzero(~old).flatten()
    k = min(cols.numel(), free.numel())
    N_p = want.shape[0] // P
    pp = pre["p_prime"]
    blk = want[pp * N_p:(pp + 1) * N_p]
    blk[:, free[:k]] = Z_t[:, cols[:k]].to(want.dtype)
    return n + off(side["Z"], want)


def hybrid_numbers(pre: dict, side: dict, X, X_eval, hyp: dict, P: int,
                   L: int, sweeps: list, tails: list,
                   n_eval_sweeps: int = 3, control: bool = False
                   ) -> dict[str, float]:
    """The numbers of one hybrid iteration (``pre`` → ``side``)."""
    N, K = side["Z"].shape
    chain = stage_chain(pre, side, sweeps, tails, P, L)
    dec = math.inf
    if math.isfinite(chain):
        u = ref.hybrid_uniforms(pre["key"], P, N // P, K, L, X.device)
        dec = sweep_margins(X, pre, sweeps, u, control)
        del u
        dec = max(dec, tail_margins(X, pre, sweeps, tails, P, control))
    out = {"decision_margin": dec, "stage_chain": chain}
    want = ref.hybrid_sync(pre, side["Z"], X, hyp, P)
    ll_t = ref.joint_ll(X, side["Z"], side["A"], side["pi"], side["active"],
                        side["sigma_x"])
    ll_e = ref.heldout_ll(X_eval, side["A"], side["pi"], side["active"],
                          side["sigma_x"], keys.fold_in(side["key"], 999),
                          n_eval_sweeps)
    out["sync_gap"] = max(_draws(side, want, want["active"] > 0.5),
                          _rel(side["ll_train"], ll_t),
                          _rel(side["ll_eval"], ll_e))
    m = side["Z"].sum(0)
    out["live_mask"] = float(((side["active"] > 0.5) != (m > 0.5)).sum())
    out["keys"] = float((side["key"] != want["key"])
                        + (side["p_prime"] != want["p_prime"])
                        + (side["it"] != pre["it"] + 1))
    return out


def uncollapsed_numbers(pre: dict, side: dict, X, hyp: dict,
                        control: bool = False) -> dict[str, float]:
    """The numbers of one serial uncollapsed step (``pre`` → ``side``)."""
    K = side["Z"].shape[1]
    ones = torch.ones((K,), dtype=torch.float32, device=X.device)
    kz = keys.split(pre["key"], 7)[1]
    u = torch.rand(side["Z"].shape, generator=keys.generator(kz, X.device),
                   dtype=torch.float32, device=X.device)
    full = dict(pre, active=ones)
    out = {"decision_margin": sweep_margins(
        X, full, [(pre["Z"], side["Z"])], [u], control)}
    del u
    want = ref.uncollapsed_sync(pre, side["Z"], X, hyp)
    out["sync_gap"] = _draws(side, want, ones > 0.5)
    out["keys"] = float((side["key"] != want["key"])
                        + (side["it"] != pre["it"] + 1))
    return out


def hybrid_control(pre: dict, prog: dict, X, X_eval, hyp: dict, P: int,
                   n_eval_sweeps: int = 3) -> dict:
    """The reference at TF32 in the program's place for the sync and the
    eval, from the program's Z; judged as the program is."""
    s = ref.hybrid_sync(pre, prog["Z"], X, hyp, P, prec="tf32")
    side = dict(prog, A=s["A"].float(), pi=s["pi"].float(),
                active=s["active"], sigma_x=s["sigma_x"].float(),
                sigma_a=s["sigma_a"].float(), alpha=s["alpha"].float(),
                key=s["key"], p_prime=s["p_prime"], it=pre["it"] + 1)
    side["ll_train"] = float(ref.joint_ll(
        X, prog["Z"], side["A"], side["pi"], side["active"],
        side["sigma_x"], prec="tf32"))
    side["ll_eval"] = float(ref.heldout_ll(
        X_eval, side["A"], side["pi"], side["active"], side["sigma_x"],
        keys.fold_in(side["key"], 999), n_eval_sweeps, prec="tf32"))
    return side


def uncollapsed_control(pre: dict, prog: dict, X, hyp: dict) -> dict:
    """The reference's uncollapsed draws at TF32 from the program's Z,
    judged as the program is."""
    s = ref.uncollapsed_sync(pre, prog["Z"], X, hyp, prec="tf32")
    return dict(prog, A=s["A"].float(), pi=s["pi"].float(),
                sigma_x=s["sigma_x"].float(), sigma_a=s["sigma_a"].float(),
                alpha=s["alpha"].float(), key=s["key"], it=pre["it"] + 1)

