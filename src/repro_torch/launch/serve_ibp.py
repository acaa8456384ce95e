"""Posterior-predictive serving loop over a harvested ``SampleBank``.

Port of ``repro.launch.serve_ibp``, the inference counterpart of
``launch/mcmc.py``: load a bank harvested with ``--harvest-every``, then
run a microbatching request loop

    queue → pad-to-bucket → one (S × B)-batched score → respond

Requests of ragged sizes are coalesced up to ``--batch`` rows, padded to
a power-of-two row bucket (8, 16, ..., batch), scored in one call across
the whole ensemble (``core.ibp.predict``), fetched to the host and
answered per request. Throughput (rows/s) and latency percentiles are
reported: each coalesced request is charged its microbatch's full
dispatch wall time, ended by the host fetch of the result; queueing
before the dispatch is not modeled. ``--bench-json`` merges them into a
JSON file under the ``"serving_loop"`` key.

Usage:
  # fit + harvest, then serve the bank (on the card; --device cpu runs
  # the plain PyTorch path on the CPU)
  python -m repro_torch.launch.mcmc --N 500 --iters 400 --harvest-every 10 \\
      --ckpt-dir artifacts/ckpt/mcmc
  python -m repro_torch.launch.serve_ibp --bank artifacts/ckpt/mcmc/bank.npz \\
      --op loglik --requests 64

Knobs:

  --bank PATH          SampleBank npz (from --harvest-every / save_bank)
  --op loglik|anomaly|encode|impute
                       which predictive op the loop serves
  --batch INT          microbatch row budget per dispatch (default 256)
  --requests INT       synthetic requests to generate
  --max-request INT    max rows per synthetic request
  --missing FLOAT      missing-dim fraction for --op impute masks
  --n-sweeps INT       Gibbs sweeps per sample inside the scorer
  --seed INT           request-stream seed
  --device cuda|cpu    where the bank is scored (default cuda; raises
                       without a GPU)
  --bench-json PATH    merge the serving section here (default "none":
                       nothing is written; "" = repo-root
                       BENCH_<date>.json)
  --smoke              tiny sizes + sanity checks
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import update_json
from repro_torch.core.ibp import math as ibm
from repro_torch.core.ibp import predict

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

OPS = ("loglik", "anomaly", "encode", "impute")


def row_buckets(batch: int) -> tuple[int, ...]:
    """Power-of-two row-count ladder 8, 16, ..., batch: the feature
    bucket ladder applied to the batch's row axis."""
    return ibm.live_buckets(batch)


def pad_to_bucket(X: np.ndarray, buckets: tuple[int, ...]) -> np.ndarray:
    """Zero-pad rows up to the smallest bucket that fits (zero rows are
    scored too; callers slice the first len(X) results)."""
    n = X.shape[0]
    B = ibm.pick_bucket(buckets, n, 0)
    if B == n:
        return X
    return np.concatenate([X, np.zeros((B - n, X.shape[1]), X.dtype)])


def make_op(bank: predict.SampleBank, op: str, n_sweeps: int):
    """The scorer of one op: fn(X_padded, mask, key) -> host numpy array.

    Every op is one (S × B)-batched call, and the result is fetched to
    the host, which waits for the device. Only ``impute`` reads the
    request masks; the other ops score complete rows (``mask=None``, the
    scorer's unmasked path)."""
    ops = {
        "loglik": lambda X, m, k: predict.predictive_loglik(
            bank, X, k, n_sweeps=n_sweeps),
        "anomaly": lambda X, m, k: predict.anomaly_score(
            bank, X, k, n_sweeps=n_sweeps),
        "encode": lambda X, m, k: predict.encode(
            bank, X, k, n_sweeps=n_sweeps),
        "impute": lambda X, m, k: predict.impute(
            bank, X, m, k, n_sweeps=n_sweeps),
    }
    if op not in ops:
        raise ValueError(f"op={op!r} not in {OPS}")
    score = ops[op]
    return lambda X, m, k: score(X, m, k).cpu().numpy()


def synth_requests(n_requests: int, max_rows: int, D: int, seed: int,
                   missing: float, X: np.ndarray | None = None):
    """Synthetic request stream: ragged requests of 1..max_rows rows, each
    with an observation mask (at least one observed dimension a row).
    Rows come from ``X`` in order, cycling, or by default from Cambridge
    data (plain noise when the bank's D is not Cambridge's)."""
    from repro_torch.data import cambridge_data

    rng = np.random.default_rng(seed)
    if X is None:
        N = max(n_requests * max_rows, 64)
        X, _, _ = cambridge_data(N=N, sigma_n=0.5, seed=seed + 1)
        if X.shape[1] != D:
            X = rng.normal(size=(N, D)).astype(np.float32)
    elif X.shape[1] != D:
        raise ValueError(f"request rows have D={X.shape[1]}, the bank "
                         f"D={D}")
    reqs, at = [], 0
    for _ in range(n_requests):
        n = int(rng.integers(1, max_rows + 1))
        rows = X[np.arange(at, at + n) % X.shape[0]]
        at += n
        mask = (rng.random(rows.shape) >= missing).astype(np.float32)
        mask[mask.sum(axis=1) < 1.0, 0] = 1.0
        reqs.append((rows.astype(np.float32), mask))
    return reqs


def serve(bank: predict.SampleBank, reqs, op: str, batch: int,
          n_sweeps: int, seed: int):
    """The microbatching loop. Returns (responses, stats dict)."""
    buckets = row_buckets(batch)
    fn = make_op(bank, op, n_sweeps)
    key = prng.key(seed)

    # score each row bucket once before timing, so that the latencies are
    # the steady state's (first-call set-up of the device's libraries)
    D = bank.D
    t0 = time.perf_counter()
    for B in buckets:
        z = np.zeros((B, D), np.float32)
        fn(z, np.ones_like(z), key)
    t_warm = time.perf_counter() - t0

    # oversized requests are split into <= batch fragments up front; each
    # keeps its request index so that every request gets one response
    frags = []
    for ri, (rows, mask) in enumerate(reqs):
        for at in range(0, rows.shape[0], batch):
            frags.append((ri, rows[at:at + batch], mask[at:at + batch]))

    parts: dict[int, list] = {ri: [] for ri in range(len(reqs))}
    req_lat_us = [0.0] * len(reqs)
    rows_done = 0
    t0 = time.perf_counter()
    i = 0
    while i < len(frags):
        # coalesce queued fragments up to the batch row budget
        take, n_rows = [], 0
        while i < len(frags) and n_rows + frags[i][1].shape[0] <= batch:
            take.append(frags[i])
            n_rows += frags[i][1].shape[0]
            i += 1
        Xb = np.concatenate([r for _, r, _ in take])
        Mb = np.concatenate([m for _, _, m in take])
        t_req = time.perf_counter()
        Xp = pad_to_bucket(Xb, buckets)
        Mp = pad_to_bucket(Mb, buckets)
        key, kreq = prng.split(key, 2)
        out = fn(Xp, Mp, kreq)
        # respond: slice the batched result back per fragment
        out = out[..., :n_rows, :] if op == "encode" else out[:n_rows]
        at = 0
        for ri, rows, _ in take:
            n = rows.shape[0]
            parts[ri].append(out[..., at:at + n, :] if op == "encode"
                             else out[at:at + n])
            at += n
        dt = time.perf_counter() - t_req
        # every request of the microbatch waits for the whole dispatch; a
        # request split over several microbatches waits for each of them
        for ri in {ri for ri, _, _ in take}:
            req_lat_us[ri] += dt * 1e6
        rows_done += n_rows
    t_total = time.perf_counter() - t0

    def assemble(p):
        if len(p) == 1:
            return p[0]
        if not p:  # zero-row request: an empty response of the right shape
            if op == "encode":
                return np.zeros((bank.S, 0, bank.K), np.float32)
            return np.zeros((0, D) if op == "impute" else (0,), np.float32)
        return np.concatenate(p, axis=-2 if op == "encode" else 0)

    responses = [assemble(parts[ri]) for ri in range(len(reqs))]
    lat = np.asarray(sorted(req_lat_us)) if req_lat_us else np.zeros(1)
    dev = bank.A.device
    stats = {
        "op": op, "S": bank.S, "K": bank.K, "D": bank.D,
        "batch": batch, "n_sweeps": n_sweeps,
        "requests": len(reqs), "rows": rows_done,
        "rows_per_s": rows_done / max(t_total, 1e-9),
        "latency_p50_us": float(lat[len(lat) // 2]),
        "latency_p95_us": float(lat[min(len(lat) - 1,
                                        int(0.95 * len(lat)))]),
        "warmup_s": t_warm,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    return responses, stats


def merge_bench_json(stats: dict, path: str) -> str:
    """Append the serving stats to the JSON file at ``path`` ("" = the
    repo-root BENCH_<date>.json) under ``"serving_loop"``."""
    if not path:
        path = os.path.join(
            REPO_ROOT, f"BENCH_{datetime.date.today().isoformat()}.json")

    def add(payload: dict) -> dict:
        payload.setdefault("serving_loop", []).append(stats)
        return payload

    return update_json(path, add)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bank", required=True,
                    help="SampleBank npz (launch.mcmc --harvest-every)")
    ap.add_argument("--op", default="loglik", choices=OPS)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-request", type=int, default=48)
    ap.add_argument("--missing", type=float, default=0.25)
    ap.add_argument("--n-sweeps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) scores on the GPU and raises "
                         "without one; cpu runs the plain PyTorch path")
    ap.add_argument("--bench-json", default="none",
                    help='where to merge the serving_loop stats: "none" '
                         '(default: nothing is written), "" = repo-root '
                         'BENCH_<date>.json, or an explicit path')
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes + sanity checks")
    args = ap.parse_args(argv)

    if args.smoke:
        args.requests = min(args.requests, 8)
        args.max_request = min(args.max_request, 12)
        args.batch = min(args.batch, 32)

    bank = predict.SampleBank.load(args.bank, device=args.device)
    chains = sorted(set(bank.chain.tolist()))
    print(f"bank: S={bank.S} samples, K={bank.K} features (bucket-"
          f"packed), D={bank.D}, chains={chains}")
    reqs = synth_requests(args.requests, args.max_request, bank.D,
                          args.seed, args.missing if args.op == "impute"
                          else 0.0)
    responses, stats = serve(bank, reqs, args.op, args.batch,
                             args.n_sweeps, args.seed)
    print(f"op={stats['op']} on {stats['device']}: {stats['rows']} rows / "
          f"{stats['requests']} requests -> "
          f"{stats['rows_per_s']:.0f} rows/s, "
          f"p50={stats['latency_p50_us']:.0f}us "
          f"p95={stats['latency_p95_us']:.0f}us "
          f"(warmup {stats['warmup_s']:.1f}s)")

    if args.smoke:
        if len(responses) != len(reqs):
            raise RuntimeError(f"{len(responses)} responses to "
                               f"{len(reqs)} requests")
        for (rows, _), resp in zip(reqs, responses):
            n = rows.shape[0]
            got = resp.shape[-2] if args.op == "encode" else resp.shape[0]
            if got != n:
                raise RuntimeError(f"response rows {got} != request rows "
                                   f"{n}")
            if not np.all(np.isfinite(resp)):
                raise RuntimeError("non-finite scores")
        print("smoke OK")

    if args.bench_json != "none":
        path = merge_bench_json(stats, args.bench_json)
        print(f"serving section -> {path}")
    return responses, stats


if __name__ == "__main__":
    main()
