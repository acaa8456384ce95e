"""IBP hybrid-MCMC launcher of the port.

The CLI builds a ``SamplerSpec`` and hands it to ``MCMCDriver``, as
``repro.launch.mcmc`` does, with the reference's flags plus ``--device``
(default ``cuda``; ``cuda:<i>`` names a card; ``cpu`` runs the plain
PyTorch versions of the kernels). ``--driver shardmap`` runs when every
process is a rank of a group of P, ``--driver mesh`` (C chains x P data
shards) of a group of C·P: started by ``torch.distributed.run`` (the
group is joined here, on ``--device``), or inside
``repro_torch.parallel.spawn``. Only rank 0 prints and writes ``--out``.

Usage:
  python -m repro_torch.launch.mcmc --N 1000 --P 5 --iters 1000 --L 5
  python -m repro_torch.launch.mcmc --device cpu --N 120 --P 3 --iters 30
  # C chains on one device (R-hat / ESS columns), bounded staleness
  python -m repro_torch.launch.mcmc --driver multichain --chains 4 \
      --stale-sync 1 ...
  # P=4 ranks, one shard each; --device cuda:0 puts the 4 on one card
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.mcmc --driver shardmap --P 4 --sync fused \
      --device cpu ...
  # C=2 chains x P=2 shards on 4 ranks (R-hat / ESS columns)
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.mcmc --driver mesh --chains 2 --P 2 \
      --device cpu ...

Posterior-predictive harvest:

  --harvest-every INT   harvest one posterior sample into the SampleBank
                        every this many iterations (0 = off)
  --harvest-burn FLOAT  fraction of the run discarded before harvesting
                        starts (default 0.5)
  --bank-path PATH      bank npz (default <ckpt-dir>/bank.npz); serve it
                        with repro_torch.launch.serve_ibp
"""
from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch import parallel
from repro_torch.core.ibp import IBPHypers, SamplerSpec
from repro_torch.core.ibp.api import DRIVERS, SWEEP_BACKENDS
from repro_torch.core.ibp.collapsed import DEFAULT_REFRESH
from repro_torch.data import cambridge_data, train_eval_split
from repro_torch.runtime import MCMCDriver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=1000)
    ap.add_argument("--P", type=int, default=5)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--L", type=int, default=5)
    ap.add_argument("--K-max", type=int, default=32)
    ap.add_argument("--K-tail", type=int, default=8,
                    help="in-flight tail features on shard p' (the "
                         "collapsed-birth truncation; <= K_max)")
    ap.add_argument("--k-tail-grow", type=int, default=0,
                    help="adaptive K_tail: maximum automatic tail "
                         "doublings at checkpoint boundaries when the "
                         "tail-saturation counter (eval record "
                         "'tail_sat') accrues; 0 = fixed K_tail, "
                         "ceiling is K_max (DESIGN.md §12)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sigma-n", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt/mcmc")
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--driver", default="vmap", choices=sorted(DRIVERS),
                    help="parallelism layout: vmap (single device), "
                         "multichain (C chains on one device), shardmap (P "
                         "ranks, one data shard each: run under "
                         "torch.distributed.run --nproc-per-node P), mesh "
                         "(C chains x P data shards: --nproc-per-node C*P)")
    ap.add_argument("--chains", type=int, default=None,
                    help="chain count for --driver multichain/mesh "
                         "(default 4 / 2); values > 1 require a chainful "
                         "driver")
    ap.add_argument("--sync", default="staged", choices=["staged", "fused"],
                    help="master-sync schedule for --driver shardmap and "
                         "mesh: staged (3 all-reduces over the data axis "
                         "an iteration) or fused (1)")
    ap.add_argument("--backend", default="jnp", choices=SWEEP_BACKENDS,
                    help="the reference's sweep implementation; kept in "
                         "the spec for parity and inert here: the device "
                         "chooses the kernel")
    ap.add_argument("--stale-sync", type=int, default=0,
                    help="bounded-staleness passes per iteration (non-exact)")
    ap.add_argument("--collapsed-backend", default="fast",
                    choices=["ref", "fast", "pallas"],
                    help="tail collapsed row step (default: fast — the "
                         "rank-one Cholesky carry with the rss bit flip "
                         "and the carried G = HH^T; pallas: the same "
                         "carry with the mean-form flip; each is one "
                         "collapsed_scan launch per tail sub-iteration on "
                         "the card). ref keeps the fresh O(K^3) "
                         "factorization per row")
    ap.add_argument("--k-live-buckets", default="on", choices=["on", "off"],
                    help="occupancy-adaptive packing of the collapsed "
                         "carry (DESIGN.md §14); kept in the spec for "
                         "parity with the reference and inert here: the "
                         "hybrid tail runs the same float path at the "
                         "full K_tail width either way")
    ap.add_argument("--chol-refresh", type=int, default=DEFAULT_REFRESH,
                    help="exact-refactorization cadence of the tail's "
                         "collapsed carry (rows between refreshes)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a rank's own card under "
                         "shardmap) runs the CUDA kernels and raises "
                         "without a GPU; cuda:<i> names the card (several "
                         "ranks on one card); cpu runs their plain "
                         "versions")
    ap.add_argument("--harvest-every", type=int, default=0,
                    help="SampleBank harvest cadence in iterations "
                         "(0 = off)")
    ap.add_argument("--harvest-burn", type=float, default=0.5,
                    help="fraction of the run discarded as burn-in "
                         "before harvesting starts")
    ap.add_argument("--bank-path", default="",
                    help="SampleBank npz path (default: "
                         "<ckpt-dir>/bank.npz)")
    ap.add_argument("--out", default="artifacts/mcmc_history.json")
    args = ap.parse_args(argv)
    # a process started by torch.distributed.run joins its group here
    # (outside one, build_sampler refuses the layout)
    joined = (args.driver in ("shardmap", "mesh")
              and parallel.world() is None and "RANK" in os.environ)
    if joined:
        parallel.init_group(device=args.device)
    try:
        return _run(args)
    finally:
        if joined:
            parallel.destroy_group()


def _run(args):
    rank0 = parallel.world() is None or parallel.world().rank == 0
    X, _, _ = cambridge_data(N=args.N, sigma_n=args.sigma_n, seed=args.seed)
    X_train, X_eval = train_eval_split(X, eval_frac=0.1, seed=args.seed)
    # explicit --chains passes through so spec validation can reject it
    # loudly under a chainless driver; the default never does
    default_chains = {"multichain": 4, "mesh": 2}.get(args.driver, 1)
    spec = SamplerSpec.for_driver(
        args.driver,
        n_chains=(args.chains if args.chains is not None else default_chains),
        sync=args.sync, stale_sync=args.stale_sync, backend=args.backend,
        P=args.P, K_max=args.K_max, K_tail=args.K_tail, L=args.L,
        n_iters=args.iters, eval_every=args.eval_every,
        ckpt_dir=args.ckpt_dir, seed=args.seed,
        collapsed_backend=args.collapsed_backend,
        chol_refresh=args.chol_refresh, k_tail_grow=args.k_tail_grow,
        k_live_buckets=args.k_live_buckets,
        harvest_every=args.harvest_every, harvest_burn=args.harvest_burn,
        bank_path=args.bank_path,
    )
    drv = MCMCDriver(X_train, spec, IBPHypers(), X_eval=X_eval,
                     device=args.device)

    def show(r):
        line = (
            f"it={r['it']:5d} t={r['t']:7.1f}s K+={r['K']:4.1f} "
            f"alpha={r['alpha']:.2f} sx={r['sigma_x']:.3f} "
            f"ll_eval={r.get('joint_ll_eval', float('nan')):.1f} "
            f"Ktail={r['K_tail']}"
        )
        if r.get("tail_sat", 0):
            line += f" sat={r['tail_sat']}"
        if "sigma_x_rhat" in r and math.isfinite(r["sigma_x_rhat"]):
            line += (f" rhat(sx)={r['sigma_x_rhat']:.3f}"
                     f" ess(sx)={r['sigma_x_ess']:.0f}")
        print(line, flush=True)

    drv.run(on_eval=show if rank0 else None)
    if not rank0:
        return drv

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        # early eval records carry NaN diagnostics (not enough draws);
        # bare NaN is not valid JSON — emit null instead
        json.dump(_json_safe(drv.history), fh, indent=1)
    print(f"history -> {args.out}")
    if drv.bank_builder is not None and len(drv.bank_builder):
        # saved by the driver with the last iteration's checkpoint
        print(f"sample bank ({len(drv.bank_builder)} samples) -> "
              f"{drv.bank_path}")
    return drv


def _json_safe(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_safe(v) for v in obj]
    return obj


if __name__ == "__main__":
    main()
