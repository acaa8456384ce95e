#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

Phases, each of which raises on failure (exit code non-zero):

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: the five CUDA kernels from src/repro_torch/kernels/csrc into
   build/repro_torch_kernels (one nvcc per source, in parallel); the
   HMMA (tensor-core) instructions of each kernel in its SASS.
3. Kernels against their plain PyTorch versions at the main path's
   shapes (gibbs_flip: the sweep's N=32768 and the held-out eval's
   N=1024 from Z=0, beside one read of X and the product X A^T alone;
   collapsed_scan: one tail sub-iteration, N_p rows, and 1024 rows at
   the grown K_tail 16 and 32; with Gibbs births, 512 rows at K=32, 64,
   16, and 4 with births common; each plain scan runs once, timed, the
   tail sub-iteration's on the card and the others, here and in phases
   9, 10, 12 and 14, on the host, where the row loop is faster;
   gaussian_sse: the sync's N=32768 in float32 and bfloat16, a
   real-valued Z, and the held-out eval's N=1024). Each
   kernel's device time (torch.profiler) and call time (CUDA events) are
   medians of REPS calls, beside its plain version, a one-call PyTorch
   yardstick where there is one, and the least time the card could take
   (bound).
4. The CLI (repro_torch.launch.mcmc) on Cambridge data, 40 iterations.
5. Full width through MCMCDriver: a planted linear-Gaussian IBP matrix,
   N=32768, D=1024, K_max=64, P=8, L=5, 3 iterations, under the default
   tail (collapsed_backend "fast": the rss flip with the carried G).
6. (Checked last, after phase 17.) The kernel that carries each TPU
   kernel on the main path (CARRIED_BY: collapsed_row's recurrence runs
   inside collapsed_scan) had its launch counter rise in phases 4, 5,
   11, 12, 13 and 14 (gibbs_flip in 11 also through the naive scorer;
   in 13 and 14 on the ranks, which send their counts to this process),
   and collapsed_scan and feature_stats theirs in phases 9 and 10, and
   gibbs_flip and collapsed_scan theirs in phase 15d.
7. Capacity restarts and adaptive K_tail at full width: phase 5's
   checkpoint restored under K_max=128 with k_tail_grow=2 and a
   checkpoint every iteration, run to iteration 6 with tail saturation
   forced at every step, so K_tail goes 8 -> 16 -> 32 (s/iteration at
   each); the tail at K_tail 16 and 32 timed as phase 5 times 8; the
   sweep, feature_stats and gaussian_sse at K_max=128 against their
   plain versions; then the last checkpoint restored under the smallest
   multiple of 8 >= K+ + 8 and run one iteration (the shrink).
8. The serial uncollapsed baseline (uncollapsed_step) at full width:
   phase 5's data, K=64 all active, 5 steps, each launching gibbs_flip,
   feature_stats and gaussian_sse once; the sweep kernel at this shape
   (all 64 columns active) against its plain version.
9. The serial collapsed sampler (collapsed_sweep, Gibbs births) at full
   width, in its full-width mode (backend "pallas", the mean-form flip,
   k_live_buckets "off": one scan launch a sweep): phase 5's data,
   K_max=32 from K_init=4, one warm and 2 timed
   sweeps, each launching feature_stats and collapsed_scan once and no
   other kernel; the scan's carried ZᵀZ and m exact against its Z; each
   sweep's sigma moves replayed from its keys (proposal, difference,
   decision) and equal to the sampler's; the sigma_x MH's collapsed
   log-likelihoods in float32 and float64; feature_stats on the last
   sweep's entry Z, and the scan over the first 512 rows of that sweep's
   own inputs, against their plain versions (the prefix's Z equal to the
   sweep's own rows); then one sweep at K_max=64, feature_stats held on
   its entry and returned Z.
10. The packed collapsed carry: collapsed_scan held against its plain
   version on 512 rows of phase 5's data in the rss flavor with the
   carried G at the tail's K=8 (MH births), with Gibbs births at buckets
   16 and 32 of K_can=64 in both flavors, and on a forced overflow
   (ovf_row equal to the plain scan's); collapsed_sweep with
   k_live_buckets "on" (the default) under backends "fast" and "pallas"
   at phase 9's K_max=64 from the same start, on the first 8192 of
   phase 5's rows: one warm sweep (its seg_log), one timed, one
   profiled, and "off" against "on" from the same final state; "off" against "on" from a state whose K+ stays below
   K_max (20 planted columns, sigma_x at the data's noise); phase 5's
   iteration and tail re-timed under each collapsed backend. The
   overflow exit is timed on fresh copies of its case, its bound counted
   over the rows it scanned.
11. Posterior-predictive serving at phase 5's widths: MCMCDriver with
   harvest_every=1, harvest_burn=0.2 for 20 iterations (S=16 samples;
   the bank's K bucket, each sample's K+, the harvest's host seconds per
   iteration; the saved npz loaded back equal bitwise); the batched
   scorer on 256 held-out rows, card against CPU on the same pre-drawn
   uniforms, unmasked and masked (a differing Z bit only at a
   float-boundary event, |logit - u| < 1e-4); encode (64 sweeps) against
   exact_posterior on a bank of 12 planted features (bucket 16, D=1024,
   8 rows, tolerance 4 x 0.5 / sqrt(32)); serve_ibp.serve for each op on
   64 requests of 1-48 held-out rows (rows/s, p50 and p95 latency,
   warm-up, launches and device busy share of a 256-row dispatch, peak
   memory); predictive_loglik_naive against predictive_loglik on 256
   rows, and gibbs_flip at the naive scorer's shape against its plain
   version; the mcmc CLI with --harvest-every and serve_ibp --smoke
   through their main functions in this process.
12. C independent chains on one card (the multichain driver) at phase
   5's widths, C=4: 3 iterations (s/iteration beside phase 5's), with
   collapsed_scan launched L times an iteration, once a sub-iteration for
   all C tails, not C x L; resumed to iteration 19 for R-hat, ESS and the
   per-chain lists of the eval record; one iteration with stale_sync=1
   (2 L scan launches). The chained collapsed_scan (one launch of C
   blocks) in the rss flavor on 512 rows of C planted cases at K=8
   (ring) and K=32 (global arena): each chain against the plain scan
   (0 decisions differ, counts equal) and bitwise equal to a single-chain
   launch from its inputs; then timed at C = 1, 4, 16 on N_p rows at K=8
   and at C = 1, 4 on 512 rows at K=32, each beside C times the
   single-chain bound.
13. The data-parallel layout (data="shardmap"): phase 5's P=8 ranks,
   processes of repro_torch.parallel.spawn sharing cuda:0 over gloo
   (NCCL refuses two ranks on one card), from phase 5's final state: 3
   iterations under the staged sync (after one untimed, whose result is
   dropped) and 3 under the fused, then one stale pass. Each rank's
   launches and collectives an iteration (gibbs_flip L, collapsed_scan
   L on p′'s rank only, feature_stats 1, gaussian_sse 1 under staged and
   0 under fused; 3 all-reduces, 1, and none in the stale pass) and
   every rank's HybridGlobal bitwise equal to rank 0's. The first
   iteration of each against the vmap layout's from the same state, and
   fused against staged: Z bits differing only in a shard whose first
   sweep, run as one call and as the rank's block, differs at a counted
   float-boundary event; p′ equal; while Z agrees, A within 1e-4 of max
   |A| and sigma_x within 1e-5. Always, the master's draws replayed here
   on the ranks' own Z: A within 1e-4 of max |A|, sigma_x (from
   gaussian_sse, so the fused sync's identity too) within 1e-5, p′
   equal. The fused sync's SSE identity within 1e-5 of gaussian_sse on
   one state. gibbs_flip, feature_stats and gaussian_sse at a rank's
   shape (N_p=4096 rows, K=64, D=1024) against their plain versions,
   timed as in phase 3. s/iteration beside phase 5's, the collectives'
   host time. One iteration in an NCCL world of one rank, bitwise equal
   to the vmap layout at P=1; the CLI under torch.distributed.run on 2
   ranks of cuda:0 (fused), on Cambridge data. One spawn of 8 ranks runs
   phase 13's rank work and then phase 14's, and one process both
   worlds of one rank: on the card's host each process's start (its
   imports and CUDA context) costs about 10 s, one after another.
14. The chains x data mesh (chains="mesh"): C=2 chains x P=4 shards on 8
   ranks sharing cuda:0 over gloo, from phase 5's final state (N_p=8192;
   chain c keyed by fold_in(key, c), p′ = c): 3 iterations under the
   staged sync (after one untimed) and 3 under the fused, then one stale
   pass. Each rank's launches an iteration as in phase 13 (collapsed_scan
   L on each chain's p′ rank only) and no collective over the chain
   axis; each chain's HybridGlobal bitwise equal on its ranks; each
   chain's first iteration against the multichain layout's at P=4 from
   the same state (phase 13's rules: Z bits differing only where a
   counted boundary event made the rank's sweep differ; A and sigma_x
   while Z agrees) and the master's draws replayed on the chain's Z;
   each chain's SSE identity. gibbs_flip, feature_stats and gaussian_sse
   at a rank's N_p=8192 rows against their plain versions, and the
   unchained collapsed_scan on a planted p′ tail of 8192 rows at K=8,
   in the tail's default rss flavor, against the plain scan on its first
   2048 rows, each timed beside its bound. The device time
   of each p′ rank's tails (CUDA events), s/iteration beside phases 5
   and 13, and whether an
   MPS daemon serves the card (without it the two chains' tails are
   time-sliced). make_sharded_scorer over each chain's 4 data ranks on
   phase 11's bank, 256 held-out rows: rows/s, and every rank's result
   within 1e-5 of the blocks scored in this process. chains="mesh" x
   data="vmap" on 2 ranks at phase 5's P=8: 2 iterations (after one
   untimed), each rank launching L of each sweep and scan, and equal to
   the multichain layout's first iteration (Z, keys, p′ and counters
   bitwise; A and sigma_x within phase 13's tolerances), s/iteration
   beside phase 12's. driver="mesh" with 1 chain x 1 shard through
   MCMCDriver in an NCCL world of one rank on cuda:0, 8192 rows, 2
   iterations with an eval each and a checkpoint: the final state, the
   eval records and the checkpoint bitwise equal to the multichain
   driver's at C=1 (the chain-axis gathers carry host payloads through
   the card under nccl).

15. The LM substrate (repro_torch.models; no kernel of its own): the
   serving CLI (repro_torch.launch.serve.main) at smollm-135m's full
   width and defaults (bf16, B=4, a 32-token prompt, 16 new tokens), then
   the same loop timed (tokens/s with the prompt's steps, wall time, peak
   device memory, beside the card's name and power limit); one set of
   float32 weights at full width drawn on the card: 2 x 32 teacher-forced
   decode steps against the "train" forward (every step's logits within
   1e-3 of max |logit|, argmaxes equal except near ties, counted), then
   its first 2 layers on the card against the CPU (1e-3 of max |logit|);
   minicpm3-4b (MLA) and whisper-large-v3 (encdec) at full width cut to 2
   layers (encoder 2): the same holds, then a bf16 serve of 8 tokens. One
   JSON line a model. 15d: examples/ibp_over_lm_features.py with the port:
   the full-width float32 backbone embeds 128 windows of 32 tokens
   (SyntheticLM seed 3, step 1), the mean-pooled logits standardised and
   projected to D=64, then the hybrid sampler (P=4, K_max=16, K_tail=6,
   K_init=2, L=3) for 40 iterations: K+ >= 1, gibbs_flip and
   collapsed_scan launched.

16. The LM's other temporal mixers (repro_torch.models.ssm, rglru, moe;
   no kernel of their own, and none of the five is launched):
   falcon-mamba-7b (64 mamba-1 layers, d=4096) and recurrentgemma-2b (8
   superblocks of rec, rec, local attention and 2 tail rec blocks,
   d=2560, vocab 256000) at full width and depth through the serving CLI,
   then the timed serve and a profiled bf16 step on float32 weights drawn
   on the card, which phase 15's holds take first (2 x 32 decode steps
   against the forward at full depth; card against CPU at 2 layers, the
   hybrid at its first superblock); the hybrid's ring cache wrapped: one
   superblock, 2112 decode steps through its 2048 slots against the
   forward. phi3.5-moe-42b-a6.6b (2 layers) and deepseek-v2-236b (1
   layer, MLA, 160 routed experts top-6 and 2 shared) at full width: card
   against CPU (logits, aux), 2 x 4 decode steps on the card against the
   same on the CPU (tokens equal outside near ties), decode against the
   forward at a
   capacity that drops nothing (held) and at the config's 1.25 (reported:
   decode's T = B gives C = 1, so routed slots drop), a bf16 serve of 8
   tokens.

17. LM training (repro_torch.optim, models.make_train_step,
   launch/train.py; no kernel of their own, and none of the five is
   launched): (a) the training CLI at smollm-135m's full width and depth
   and its defaults (bf16 on float32 masters, remat, B=8, S=256), 30
   steps with a checkpoint every 10, in this process: the median step
   wall over steps 5-30 (host clock ended by a device synchronise),
   tokens/s, peak device memory, the first and last loss, then one more
   step profiled (kernels, device time, busy share); a second process
   resumed from the step-20 checkpoint (losses 21-30 within 1e-3
   relative of the first run's); 3 steps without remat (peak device
   memory). (b) float32 at full
   width (30 layers, B=2, S=64): the loss and every reference leaf's
   gradient card against CPU (1e-5 relative; 1e-4 of the leaf's max
   |g|), AdamW's update card against CPU on the CPU's gradients. (c)
   falcon-mamba-7b (1 layer; micro_batches 2), recurrentgemma-2b (one
   superblock), phi3.5-moe-42b-a6.6b (1 layer; int8-compressed
   gradients), minicpm3-4b (MLA, 1 layer) and whisper-large-v3 (1 + 1
   layers; micro_batches 8) at full width: the float32 holds of (b) on
   2 x 32 tokens, then two bf16 train steps each on fresh batches,
   timed. deepseek-v2-236b's one layer holds 90 GB of training state
   and is left out.

18. The LM on a mesh (repro_torch.parallel.mesh, parallel.shard_model,
   the steps with specs; no kernel of their own, and none of the five is
   launched): the 8 ranks of phases 13-14's spawn (cuda:0, gloo), after
   their jobs, as a (4, 2) (data, model) mesh. smollm-135m whole (30
   layers, d=576): 3 sharded train steps at the training CLI's defaults
   (bf16 on float32 masters, remat, B=8, S=256, the batch pre-shifted so
   the sequence splits over model), each step's wall, collectives by kind
   and group with their host seconds, peak device memory by rank; rank 0
   runs the same steps unsharded (losses, the first gradient and the
   weights held at bf16's tolerances); float32 at B=2, S=64: the loss,
   every gradient and AdamW's update on the same gradients against the
   unsharded port; layers.0.attn.wq spread over the ranks; 4
   teacher-forced float32 decode steps at B=4 on caches stored sharded,
   the argmaxes the unsharded decode's. phi3.5-moe-42b-a6.6b's one layer
   at full width in float32 with moe_impl "a2a" on 2 x 32 tokens against
   the gather dispatch at capacity E / top_k (loss, aux, gradients).
   Logged after phase 17.

19. The dry run (repro_torch.launch.dryrun) on the card: the fake
   process group and fake tensors import, or the phase fails. The IBP
   cell at pod1 (2^20 Cambridge rows over a fake world of 256 ranks,
   this process rank p′ = 0 running one real iteration of its 4096 rows
   at K_max=64, K_tail=8, L=5), staged and fused: 3 and 1 all-reduces,
   and gibbs_flip L, collapsed_scan L, feature_stats 1 and gaussian_sse
   1 (staged) or 0 (fused) launches, else it raises; the four kernels at
   the cell's shapes against their plain versions (a vmap sampler on
   the same 4096 rows after 3 iterations; the scan on a planted tail of
   4096 rows at K=8, D=36, held on its first 1024). Three LM cells at
   full width on fake cuda tensors, cut in depth to the reference's two
   depth probes (run_probe: 1 and 2 layers at the full model's
   parameter bytes; the sweep of every cell at full depth is its own
   command, README), each "ok" with the device's allocated memory
   unchanged: smollm-135m train_4k pod1, phi3.5-moe-42b-a6.6b
   decode_32k pod1, deepseek-v2-236b prefill_32k pod2 (past the serve
   weight budget: inference-FSDP). Against phase
   18: the dry run of its bf16 step (the same (4, 2) mesh, B=8, S=256,
   remat) makes the same collectives by kind and group as each of
   phase 18's counted steps, and its peak estimate lies within
   DRYRUN["peak_band"] of rank 0's measured peak; the same step on real
   tensors of the card in a fake world: the tracker's peak over it equal
   to the estimate less its cuBLAS workspaces, the allocator's within 1%
   of the tracker's.

The last line is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON, and before that the card's name and power limit and the
script's total wall time. Run from the root of a checkout: python3
chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tests"))  # _torch_cases: JAX-free test inputs

REPS = 25
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
KERNELS = ("gibbs_flip", "collapsed_row", "collapsed_scan", "gaussian_sse",
           "feature_stats")
REPLACES = {
    "gibbs_flip": "src/repro/kernels/gibbs_flip/kernel.py:66",
    "collapsed_row": "src/repro/kernels/collapsed_row/kernel.py:97",
    "collapsed_scan": "src/repro/kernels/collapsed_row/kernel.py:97",
    "gaussian_sse": "src/repro/kernels/gaussian_sse/kernel.py:28",
    "feature_stats": "src/repro/kernels/feature_stats/kernel.py:36",
}
# the port kernel that runs each TPU kernel's work on the main path:
# collapsed_row's recurrence runs inside collapsed_scan, one launch per
# tail sub-iteration; the standalone collapsed_row kernel is checked in
# phase 3 only
CARRIED_BY = {
    "src/repro/kernels/gibbs_flip/kernel.py:66": "gibbs_flip",
    "src/repro/kernels/collapsed_row/kernel.py:97": "collapsed_scan",
    "src/repro/kernels/gaussian_sse/kernel.py:28": "gaussian_sse",
    "src/repro/kernels/feature_stats/kernel.py:36": "feature_stats",
}
MAIN_PATH = tuple(sorted(set(CARRIED_BY.values())))
# the kernels of the serial collapsed sampler's sweep (phase 9)
COLLAPSED_PATH = ("collapsed_scan", "feature_stats")
# phase 3: the main path's kernel shapes at full width
SHAPE = dict(N=32768, K=64, D=1024)
# phase 5: the widths the kernels' own docstrings size for
FULL = dict(N=32768, D=1024, K_max=64, K_tail=8, P=8, L=5, iters=3,
            K_true=24, p=0.3, sigma_n=0.5, N_eval=1024)
# phase 7: phase 5's run restarted at twice its K_max, K_tail doubling twice
GROWTH = dict(K_max=128, K_tails=(8, 16, 32), k_tail_grow=2, iters=6)
# phase 8: the serial uncollapsed baseline on phase 5's data
BASELINE = dict(K=64, steps=5)
# phase 9: the serial collapsed sampler on phase 5's data, then one sweep
# at benchmarks/collapsed.py's top K; the scan held on the first
# prefix_rows rows of a sweep, and phase 3's Gibbs-birth scans on
# hold_rows rows (both cut from 1024, and the timed sweeps from 3, to keep
# the run inside its time limit)
COLLAPSED = dict(K_max=32, K_init=4, alpha=3.0, warm=1, sweeps=2,
                 K_max_wide=64, prefix_rows=512, hold_rows=512)
# phase 9 measures the full-width carry with the mean-form flip, one
# launch a sweep; phase 10 the packed carry, the defaults
OFF = dict(backend="pallas", k_live_buckets="off")
# phase 10: the packed collapsed carry on phase 5's data: the scan held on
# `rows` rows (the tail's K=8, buckets 16 and 32 of K_can=64, an overflow),
# then the packed sweeps at phase 9's K_max=64 from K_init=4 on the first
# sweep_rows rows, and phase 5's iteration and tail under each collapsed
# backend. The holds' rows, the sweeps' rows and their count are cut to
# keep the run inside its time limit (from 1024, all 32768 and 2 timed)
PACKED = dict(rows=512, K_can=64, tail_K=8, buckets=(16, 32), K_max=64,
              K_init=4, alpha=3.0, warm=1, sweeps=1, sweep_rows=8192,
              iters=3)
# phase 11: posterior-predictive serving at phase 5's widths: a harvest of
# 20 iterations from iteration 5 (S=16); the batched scorer held on
# hold_rows held-out rows, card against CPU; encode against the 2^12
# enumeration (12 planted features of norm ~1.6 at sigma_x 1, so that the
# posterior is not degenerate); the serving loop at the CLI's defaults,
# on the harvested bank and, for loglik, on a bank of the planted model
# (K bucket 32: the harvest's 20 iterations stop short of the data's K+)
SERVING = dict(iters=20, harvest_every=1, harvest_burn=0.2, hold_rows=256,
               n_sweeps=3, missing=0.25, enum_K=12, enum_rows=8,
               enum_sweeps=64, enum_scale=0.05, enum_sigma=1.0, requests=64,
               max_request=48, batch=256, naive_reps=3, planted_S=16)
# phase 12: C independent chains on one card at phase 5's widths: the
# multichain driver for phase 5's 3 iterations, resumed to 19 for R-hat
# and ESS over the 16 after the restore (split-R-hat needs 4 draws a
# half-chain after the half burn-in), then one iteration with a stale
# pass; the chained collapsed_scan held on hold_rows rows of C planted
# cases at K 8 (each chain's carry in its block's shared memory) and 32
# (each in its own global arena), and timed on the tail's N_p rows at each
# C of time_C (K=8) and on hold_rows rows at each of time_C_global (K=32);
# hold_rows cut from 1024 to keep the run inside its time limit
MULTI = dict(C=4, iters=3, resume_iters=19, hold_rows=512, hold_K=(8, 32),
             time_C=(1, 4, 16), time_C_global=(1, 4), reps=10)
# phase 13: the data-parallel layout: phase 5's P ranks on cuda:0 over gloo
# (NCCL refuses two ranks on one card), iters under each sync from phase
# 5's final state, then a stale pass; a differing decision between the
# layouts' sweeps must sit within `boundary` of |logit - u|, and A within
# A_rtol of max |A|, sigma_x within sx_rtol, the fused sync's SSE identity
# within sse_rtol of gaussian_sse; the CLI on cli_ranks processes of
# torch.distributed.run (cut from 4: on the card's host each process's
# start costs about 10 s)
SHARDMAP = dict(iters=3, boundary=1e-4, A_rtol=1e-4, sx_rtol=1e-5,
                sse_rtol=1e-5, cli_ranks=2, cli_N=1000, cli_iters=20)
# phase 14: the chains x data mesh: C chains x P shards on C·P ranks of
# cuda:0 over gloo from phase 5's final state (chain c keyed by
# fold_in(key, c), p′ = c), iters under each sync after one untimed, then
# a stale pass; each chain's first iteration held against the multichain
# layout's at this P as phase 13 holds its ranks against the vmap layout
# (SHARDMAP's boundary and tolerances); chains="mesh" x data="vmap" on C
# ranks at phase 5's P, vmap_iters after one untimed, against the
# multichain layout; make_sharded_scorer over each chain's P data ranks
# on phase 11's bank: score_rows held-out rows, the median of score_reps
# timed calls, within score_tol of each block's one-process score; the
# mesh driver with one chain and one shard in an NCCL world of one rank,
# one_iters iterations on one_rows of phase 5's rows; a p′ rank's scan
# held against the plain scan on its first scan_hold_rows rows (cut from
# all N_p to keep the run inside its time limit) and timed on all N_p
MESH = dict(C=2, P=4, iters=3, vmap_iters=2, score_rows=256, score_reps=5,
            score_key=97, score_tol=1e-5, one_rows=8192, one_iters=2,
            scan_hold_rows=2048)
# phase 15: the LM substrate on the card: smollm-135m's serving CLI at its
# full width and defaults (bf16, serve_B sequences, a serve_prompt-token
# prompt, serve_new new tokens); at full width in float32, hold_B
# sequences of hold_steps teacher-forced decode steps against the "train"
# forward (rel_tol of max |logit|; argmaxes equal unless the top two are
# within tie_gap), then its first cpu_layers layers on the card against
# the CPU; the models of `cut` at full width cut to cut_layers layers
# (encoder too): the same holds, then a bf16 serve of cut_new tokens; and
# (15d) examples/ibp_over_lm_features.py's composition on the full-width
# backbone: ibp_N windows of ibp_seq tokens, features projected to ibp_D,
# the hybrid sampler at ibp_spec for ibp_iters iterations
LM = dict(arch="smollm-135m", serve_B=4, serve_prompt=32, serve_new=16,
          hold_B=2, hold_steps=32, rel_tol=1e-3, tie_gap=1e-3, cpu_layers=2,
          cut=("minicpm3-4b", "whisper-large-v3"), cut_layers=2, cut_new=8,
          ibp_N=128, ibp_seq=32, ibp_data_seed=3, ibp_data_step=1, ibp_D=64,
          ibp_proj_seed=7, ibp_iters=40,
          ibp_spec=dict(P=4, K_max=16, K_tail=6, K_init=2, L=3))

# phase 16: the LM's other temporal mixers: falcon-mamba-7b (ssm) and
# recurrentgemma-2b (hybrid) at full width and depth through the serving
# CLI, the timed serve and a profiled bf16 step, then phase 15's holds on
# their float32 weights (card against CPU at cpu_layers: the hybrid at one
# superblock, local attention included); the hybrid's ring cache wrapped:
# one superblock, ring_B sequences of local_window + ring_extra
# teacher-forced decode steps against the forward; the MoE models at full
# width cut to moe_layers: card against CPU (logits, aux), cpu_decode_steps
# decode steps on the card against the same on the CPU (greedy tokens; cut
# from phase 15's hold_steps to keep the run inside its limit), decode
# against the
# forward at a capacity that drops nothing (held) and at the config's
# (reported, with the routed slots dropped a step), a bf16 serve of
# cut_new tokens; the profiled bf16 step is the median of profile_steps
# (cut from phase 15's 8: the profiler's events of a 3,200-kernel step
# take seconds of host time to read)
MIXERS = dict(ssm="falcon-mamba-7b", hybrid="recurrentgemma-2b",
              moe_layers={"phi3.5-moe-42b-a6.6b": 2, "deepseek-v2-236b": 1},
              ring_B=1, ring_extra=64, cpu_decode_steps=4, profile_steps=4)
# phase 17: LM training: smollm-135m's training CLI at full width and depth
# and its defaults (bf16, remat, B=batch, S=seq) for cli_steps steps, a
# checkpoint every ckpt_every, then a second process resumed from the
# step-resume_from checkpoint (its losses within resume_rtol of the first
# run's: the embedding's and the MoE combine's index backward add with
# atomics on the card, so a repeat is not bitwise); the first run is in
# this process, each step timed (the median from time_from) and one more
# profiled; remat_off_steps steps without remat (peak memory); float32 at
# full width, hold_B x hold_S tokens: the loss (loss_rtol) and every
# reference leaf's gradient (grad_rel of its max |g|) card against CPU,
# AdamW's update on the CPU's gradients (adam_rel of each leaf's max); the
# models of `cut` at full width cut to that many layers (recurrentgemma:
# one superblock; deepseek-v2-236b's one layer, 5.02 B parameters, is 90
# GB of training state: it does not fit), the same float32 holds on
# hold_B x cut_S tokens, then
# bf16_steps bf16 train steps at their micro_batches (B = max(hold_B,
# micro_batches), S = bf16_S), the archs of int8 with int8-compressed
# gradients
TRAIN = dict(arch="smollm-135m", cli_steps=30, ckpt_every=10, resume_from=20,
             resume_rtol=1e-3, batch=8, seq=256, time_from=5,
             remat_off_steps=3, hold_B=2, hold_S=64, loss_rtol=1e-5,
             grad_rel=1e-4, adam_rel=1e-4,
             cut={"falcon-mamba-7b": 1, "recurrentgemma-2b": 3,
                  "phi3.5-moe-42b-a6.6b": 1, "minicpm3-4b": 1,
                  "whisper-large-v3": 1}, cut_S=32,
             int8=("phi3.5-moe-42b-a6.6b",), bf16_steps=2, bf16_S=64)


# phase 18: the LM on a mesh: the 8 ranks of phases 13-14's spawn (cuda:0,
# gloo) as a (4, 2) (data, model) mesh, after their jobs. smollm-135m
# whole: `steps` sharded train steps at the training CLI's defaults (bf16
# on float32 masters, remat, B=batch, S=seq: the batch pre-shifted, so
# the model sees S positions and the sequence splits over model), rank 0
# running the same steps unsharded (bf16: the losses within
# bf16_loss_rtol, under a tenth of what the unsharded loss falls over the
# steps; each leaf of the first step's gradient as close in norm to the
# float32 gradient as the unsharded step's is, twice its gap or
# bf16_rtol: the embedding's bf16 backward sums a frequent token's rows
# in bf16, in another order on each rank; each leaf's change over the
# steps within moved_rel of the unsharded change in norm: AdamW's near
# sign steps flip where a gradient element is near 0, and a step that
# moves nothing is 1 off); float32 at hold_B x hold_S, one make_train_step
# on the mesh: the loss (loss_rtol), every gradient (grad_rel of its max
# |g|) and the new weights against the unsharded AdamW on the step's own
# gradients (adam_rel of max |w|, adam_moved_rel of the update's max
# |change|); `decode_steps` teacher-forced float32 decode steps
# at B=decode_B on caches stored sharded, each step's argmax equal to the
# unsharded decode's unless its top two are within tie_gap; the MoE
# config's one layer at full width in float32 with moe_impl "a2a" on
# moe_B x moe_S tokens against the gather dispatch at capacity E / top_k
# (rank 0 computes the unsharded hold: ~6.2 GB of weights; no remat, so
# the expert slabs are gathered once)
LM_MESH = dict(shape=(4, 2), arch="smollm-135m", steps=3, batch=8, seq=256,
               lr=3e-4, seed=0, bf16_rtol=2e-2, bf16_loss_rtol=1e-3,
               moved_rel=0.5, hold_B=2, hold_S=64, loss_rtol=1e-5,
               grad_rel=1e-4, adam_rel=1e-4, adam_moved_rel=1e-3, decode_B=4,
               decode_steps=4, tie_gap=1e-3,
               moe="phi3.5-moe-42b-a6.6b", moe_B=2, moe_S=32)


# phase 19: the dry run on the card: the IBP cell at ibp_mesh under each
# sync (the cell's own widths: 2^20 rows, K_max=64, K_tail=8, L=5, rank
# p' = 0), the kernels held at its shapes on a vmap sampler over the same
# N_p rows after hold_iters iterations (the scan on scan_hold_rows of a
# planted tail of N_p rows), the LM cells' depth probes on fake cuda
# tensors (cut from the full depth, 24-42 s a cell on the card's host, to
# keep the run inside its time limit), and phase 18's bf16 step dry-run,
# its peak estimate within peak_band of phase 18's measured peak
DRYRUN = dict(ibp_mesh="pod1", N=1 << 20, K_max=64, K_tail=8, L=5,
              hold_iters=3, scan_hold_rows=1024, peak_band=(0.75, 1.25),
              cells=(("smollm-135m", "train_4k", "pod1"),
                     ("phi3.5-moe-42b-a6.6b", "decode_32k", "pod1"),
                     ("deepseek-v2-236b", "prefill_32k", "pod2")))


T_START = time.perf_counter()


def stamp(what: str) -> None:
    """The run's timeline on standard error: seconds since the script
    started, then what just ended."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {what[:110]}",
          file=sys.stderr, flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)
    stamp(msg)


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_events(prof) -> list:
    """The device kernels (not copies) in a torch.profiler run."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]


def device_ms(fn, names: tuple[str, ...], reps: int = REPS) -> float | None:
    """Device time of one call: the kernels whose names contain one of
    ``names``, from torch.profiler (None when the profiler sees none of
    them). The median over calls when every call was recorded; the
    profiler may drop a window's first calls, and then the mean over the
    calls it recorded (kernels per call: the distinct kernel names).
    Unlike ``time_ms`` this excludes the host's launch path, which bounds
    a call whose kernel is shorter than its launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in kernel_events(p)
                 if any(n in e.name for n in names)),
                key=lambda e: e.time_range.start)
    if not ev:
        return None
    if len(ev) % reps:
        calls = len(ev) / len({e.name for e in ev})
        return sum(e.time_range.elapsed_us() for e in ev) / calls / 1e3
    per = len(ev) // reps  # kernels per call
    calls = [sum(e.time_range.elapsed_us() for e in ev[i:i + per])
             for i in range(0, len(ev), per)]
    return statistics.median(calls) / 1e3


def timed(fn, names: tuple[str, ...], reps: int = REPS) -> dict:
    """``ms``: the kernels' device time (profiler), or the CUDA-event time
    of a call where the profiler sees nothing; ``call_ms``: the CUDA-event
    time of one wrapper call, host launch path included."""
    call = time_ms(fn, reps)
    dev = device_ms(fn, names, reps)
    return dict(ms=call if dev is None else dev, call_ms=call,
                timing="events" if dev is None else "profiler")


def library(fn, reps: int = REPS) -> dict:
    """A PyTorch yardstick timed as the kernels are: ``library_ms`` is the
    device time of every kernel the call launches (profiler), or its
    CUDA-event time where the profiler sees none; ``library_call_ms`` is
    the CUDA-event time of the call."""
    t = timed(fn, ("",), reps)  # "" matches every kernel name
    return dict(library_ms=t["ms"], library_call_ms=t["call_ms"])


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def sass_hmma(names: tuple[str, ...]) -> dict[str, dict[str, list[int]]]:
    """Tensor-core instructions in each built library's SASS
    (cuobjdump --dump-sass): {library: {kernel: [HMMA count per
    instance]}}; {} where cuobjdump is missing."""
    import re
    import shutil

    from repro_torch.kernels import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists() and shutil.which("cuobjdump") is None:
        return {}
    tool = str(tool) if tool.exists() else "cuobjdump"
    out: dict[str, dict[str, list[int]]] = {}
    for lib in names:
        sass = subprocess.run([tool, "--dump-sass", str(_build._target(lib))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        counts: dict[str, list[int]] = {}
        for part in sass.split("Function : ")[1:]:
            fn = re.findall(r"(?:^|\d)([a-z][a-z_]*_kernel)",
                            part.split("\n", 1)[0])
            counts.setdefault(fn[-1] if fn else "?", []).append(
                part.count("HMMA"))
        out[lib] = counts
    return out


def planted_data(N: int, D: int, K_true: int, p: float, sigma_n: float,
                 seed: int):
    """X = Z A + noise: K_true N(0,1) feature rows, Bernoulli(p) Z."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((K_true, D), dtype=np.float32)
    Z = (rng.random((N, K_true), dtype=np.float32) < p).astype(np.float32)
    X = Z @ A + sigma_n * rng.standard_normal((N, D), dtype=np.float32)
    return X, Z, A


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def gibbs_margin(X, Z_in, Z_out, A, lpi, inv2s2, u, n, k) -> float:
    """|logit - u| of decision (n, k) in float64, bits < k from Z_out."""
    import torch

    z = torch.cat([Z_out[n, :k], Z_out.new_zeros(1), Z_in[n, k + 1:]]).double()
    A64 = A.double()
    r = X[n].double() - z @ A64
    logit = (lpi[k].double()
             + (2.0 * r @ A64[k] - A64[k] @ A64[k]) * float(inv2s2))
    return float(abs(logit - u[n, k].double()))


def gibbs_decisions_ok(X, Z, got, want, A, lpi, inv2s2, u, tag) -> int:
    """At most a 1e-5 share of decisions differ, each row's first
    difference at |logit - u| < 1e-3 in float64; returns the count."""
    diff = (got != want).nonzero().tolist()
    frac = len(diff) / got.numel()
    if frac > 1e-5:
        raise AssertionError(f"gibbs_flip{tag}: {len(diff)} decisions differ "
                             f"({frac:.2e} > 1e-5)")
    rows = sorted({n for n, _ in diff})
    for n in rows:
        k = min(kk for nn, kk in diff if nn == n)
        m = gibbs_margin(X, Z, want, A, lpi, inv2s2, u, n, k)
        if not m < 1e-3:
            raise AssertionError(f"gibbs_flip{tag}: decision ({n},{k}) "
                                 f"differs away from the boundary "
                                 f"(|logit-u|={m})")
    return len(diff)


def gibbs_variant(X, Z, A, lpi, act, u, inv2s2, tag: str = "") -> dict:
    """The sweep kernel against its plain version (the residual form in
    float32) on these inputs, two calls bitwise equal; its times beside
    its bound."""
    import torch

    from repro_torch.kernels.gibbs_flip import gibbs_flip_core, gibbs_flip_ref

    rows, D = X.shape
    K = A.shape[0]
    args = (X, Z, A, lpi, act, u, inv2s2)
    got = gibbs_flip_core(*args)
    if not torch.equal(got, gibbs_flip_core(*args)):
        raise AssertionError(f"gibbs_flip{tag}: two calls differ")
    want = gibbs_flip_ref(*args)
    torch.cuda.synchronize()
    n_diff = gibbs_decisions_ok(X, Z, got, want, A, lpi, inv2s2, u, tag)
    # bytes: X, Z, A, logit_pi, active, u read once; Z written once.
    # operations this data needs in Gram form: P = X A^T over the
    # active columns, G over them, the carry z G over the nonzero z,
    # and one K-wide carry move per flip
    n_act = float(act.sum())
    nnz = float((Z != 0).sum())
    moved = float((got != Z).sum())
    nbytes = 4.0 * (rows * D + 3 * rows * K + K * D + 2 * K)
    flops = 2.0 * n_act * (rows * D + K * D + nnz + moved)
    b, by = bound_ms(nbytes, flops)
    return dict(
        shape=f"N={rows} K={K} D={D}{tag}", n_active=n_act,
        max_abs_err=float((got - want).abs().max()),
        mismatched_decisions=n_diff, flips=moved,
        **timed(lambda: gibbs_flip_core(*args),
                ("gibbs_gram_kernel", "gibbs_flip_kernel")),
        plain_ms=time_ms(lambda: gibbs_flip_ref(*args)),
        bound_ms=b, bound_by=by,
        # one read of X, and the product X A^T alone (no PyTorch call
        # computes the sweep, so there is no library_ms)
        read_x_ms=device_ms(lambda: X.sum(), ("",)),
        product_ms=device_ms(lambda: torch.matmul(X, A.T), ("",)))


def check_gibbs_flip(dev) -> dict:
    """The sweep at the main path's shape (N=32768) and at the held-out
    eval's (N=1024, from Z = 0)."""
    import numpy as np
    import torch

    from repro_torch.core.ibp.sweeps import _logit

    N, K, D = SHAPE["N"], SHAPE["K"], SHAPE["D"]
    X_np, _, A_true = planted_data(N, D, 24, 0.3, 0.5, seed=11)
    rng = np.random.default_rng(12)
    A_np = 0.3 * rng.standard_normal((K, D), dtype=np.float32)
    A_np[:24] = A_true + 0.05 * rng.standard_normal((24, D), dtype=np.float32)
    act_np = (np.arange(K) < 40).astype(np.float32)
    g = torch.Generator(device=dev).manual_seed(13)
    X = torch.from_numpy(X_np).to(dev)
    A = torch.from_numpy(A_np).to(dev)
    act = torch.from_numpy(act_np).to(dev)
    Z = (torch.rand((N, K), generator=g, device=dev) < 0.3).float() * act
    lpi = _logit(torch.rand((K,), generator=g, device=dev))
    u = _logit(torch.rand((N, K), generator=g, device=dev))
    inv2s2 = torch.tensor(0.5 / 0.5**2, device=dev)
    n_eval = FULL["N_eval"]
    variants = [gibbs_variant(X[:rows], Zv, A, lpi, act, u[:rows], inv2s2,
                              tag)
                for rows, Zv, tag in (
                    (N, Z, ""),
                    (n_eval, torch.zeros_like(Z[:n_eval]), " from Z=0"))]
    main = dict(name="gibbs_flip", **variants[0], library_ms=None,
                library_call=None)
    main["variants"] = variants[1:]
    return main


def collapsed_row_inputs(K: int, D: int, dev, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    act = np.ones(K, np.float32)
    Zb = (rng.random((5 * K, K)) < 0.3).astype(np.float32)
    W = Zb.T @ Zb + 0.7 * np.eye(K)
    M = np.linalg.inv(W).astype(np.float32)
    H = (M @ (Zb.T @ rng.standard_normal((5 * K, D)))).astype(np.float32)
    x = rng.standard_normal(D).astype(np.float32)
    z = (rng.random(K) < 0.4).astype(np.float32)
    v = (M @ z).astype(np.float32)
    arrays = [M, H, x, z, v, np.float32(z @ v), (z @ H).astype(np.float32),
              (rng.standard_normal(K) * 2).astype(np.float32),
              Zb.sum(0).astype(np.float32), act, np.float32(8 * K),
              np.float32(0.5)]
    return [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]


def collapsed_row_margin(args, z_out, k) -> tuple[float, float]:
    """|logodds - u| of bit k in float64, bits < k from z_out."""
    import torch

    M, H, x, z, v, q, mean, u, mm, act, N, inv2s2 = (a.double() for a in args)
    D = x.shape[0]

    def ll(zz):
        s = 1.0 + zz @ M @ zz
        r = x - zz @ H
        return -0.5 * D * torch.log(s) - inv2s2 * (r @ r) / s

    zz = torch.cat([z_out[:k].double(), z.new_zeros(1), z[k + 1:]])
    z1 = zz.clone()
    z1[k] = 1.0
    lo = (torch.log(torch.clamp(mm[k], min=1e-20)) - torch.log(N - mm[k])
          + ll(z1) - ll(zz))
    return float(abs(lo - u[k])), float(u[k])


def check_collapsed_row(dev) -> dict:
    import torch

    from repro_torch.kernels.collapsed_row import (
        collapsed_row_flip,
        collapsed_row_flip_ref,
    )

    variants = []
    for K in (8, SHAPE["K"]):
        D = SHAPE["D"]
        args = collapsed_row_inputs(K, D, dev, seed=K + D)
        got = collapsed_row_flip(*args)
        want = collapsed_row_flip_ref(*args)
        torch.cuda.synchronize()
        diff = (got[0] != want[0]).nonzero().flatten().tolist()
        if diff:
            # one float-boundary event at most: |logodds - u| < 1e-4 (1+|u|)
            m, uk = collapsed_row_margin(args, want[0], diff[0])
            if len(diff) > 1 or not m < 1e-4 * (1 + abs(uk)):
                raise AssertionError(f"collapsed_row K={K}: decisions "
                                     f"differ at {diff} (|logodds-u|={m})")
        err = 0.0
        for a, b in zip(got[1:], want[1:] if not diff else ()):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"collapsed_row K={K}: carry differs "
                                     f"by {float((a - b).abs().max())}")
            err = max(err, float((a - b).abs().max()))
        # bytes: M, H, x, z, v, q, mean, u, m, active, N, inv2s2 read and
        # z, v, q, mean written once; operations: per bit the two
        # residual norms and the mean move (about 8 D) plus the v move
        nbytes = 4.0 * (K * K + K * D + 2 * D + 5 * K + 3 + 2 * K + D + 1)
        flops = K * (8.0 * D + 4.0 * K)
        b, by = bound_ms(nbytes, flops)
        variants.append(dict(
            shape=f"K={K} D={D}", max_abs_err=err,
            **timed(lambda: collapsed_row_flip(*args),
                    ("collapsed_row_kernel",)),
            plain_ms=time_ms(lambda: collapsed_row_flip_ref(*args)),
            bound_ms=b, bound_by=by))
    main = dict(name="collapsed_row", **variants[0], library_ms=None,
                library_call=None)
    main["variants"] = variants[1:]
    return main


def scan_bound_ms(n_rows: int, K: int, D: int, k_live: float,
                  gibbs: bool, fast: bool = False) -> tuple[float, str]:
    """The scan's bound on a block of K columns. Bytes: X, the draws (u,
    and 2 MH or 5 Gumbel values a row) and Z read once at the block's
    columns, Z and the statistics written once. Operations this run's
    data needs per row, about, counted from the kernel: the removal and
    the factor moves (5 K D), the mean, and, in mean form, the flip of
    each live column (8 D each); in rss form (``fast``) the flip of each
    live column is 6 K + 20, and the row adds G's two rank-two moves
    (2 K D + 2 D each), rss and rH = H r at the entry (2 K D + 3 D), the
    mean at the exit (2 K D) and the births' rss (3 D). Far below what
    the chain of dependent rows allows."""
    nbytes = 4.0 * (n_rows * (D + 2 * K + (5 if gibbs else 2)) + n_rows * K
                    + 2 * (K * K + K * D + 2 * K))
    if fast:
        flops = n_rows * (13.0 * K * D + 16.0 * D
                          + k_live * (6.0 * K + 20.0))
    else:
        flops = n_rows * (5.0 * K * D + 8.0 * D * k_live + 6.0 * D)
    return bound_ms(nbytes, flops)


def once_ms(fn) -> float:
    """CUDA-event time of one call, no warm-up: for the plain row loops,
    whose one call takes seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def hold_scan(dev, case: dict, sx: float, sa: float, N: float, tag: str,
              rest=None, plain_dev="cpu", **scan_kw):
    """The scan kernel against its plain version (the Python row loop) on
    the same inputs and draws, the plain scan on ``plain_dev``: the host
    by default, where its row loop runs about 6 times faster than on the
    card, whose launches and host syncs it waits on a row at a time (the
    kernel line's own row, phase 3's tail scan, holds and times it on the
    card). ``case`` holds numpy arrays: the scan's
    state (Z, active, ZtZ, ZtX, m), its rows X and its draws (u_logit, and
    j_prop and log_u_acc, or gumbel and alpha); ``rest`` is as in
    ``scan_divergence``. Two launches must be bitwise equal; the kernel
    must agree with the plain scan in every decision (Z, active, m and ZᵀZ
    equal, ZᵀX within rtol 1e-5, atol 1e-4, the counts equal) unless the
    two first part at one float-boundary event (margin < 1e-3 (1 + |u|)),
    after which the chains part. The plain scan runs once, timed.
    ``scan_kw`` (the flip ``flavor``, the block ``B``) goes to both
    scans; the counts compared include ``ovf_row``, the row where a
    birth overflowed the block. Returns (report, run, tensors): ``run(fn,
    t)`` scans ``t`` with ``fn``, ``tensors()`` makes a fresh copy of the
    case on the card."""
    import numpy as np
    import torch
    from _torch_cases import scan_divergence

    from repro_torch.kernels.collapsed_scan import (
        collapsed_scan,
        collapsed_scan_ref,
    )

    refresh = 64  # the sampler's DEFAULT_REFRESH
    per_row = ("Z", "X", "u_logit", "j_prop", "log_u_acc", "gumbel")

    plain_dev = torch.device(plain_dev)

    def tensors(rows=None, on=dev):
        return {k: torch.tensor(v[:rows] if k in per_row else v, device=on)
                for k, v in case.items()}

    def run(fn, t):
        on = t["X"].device
        return fn(t["Z"], t["active"], t["ZtZ"], t["ZtX"], t["m"], t["X"],
                  t["u_logit"], t.get("j_prop"), t.get("log_u_acc"),
                  torch.tensor(sx, device=on), torch.tensor(sa, device=on),
                  N=N, refresh_every=refresh, drift_tol=1e-2,
                  gumbel=t.get("gumbel"), alpha=t.get("alpha"), **scan_kw)

    got_t, again_t = tensors(), tensors()
    want_t = tensors(on=plain_dev)
    cg, ca = run(collapsed_scan, got_t), run(collapsed_scan, again_t)
    cw = []
    if plain_dev.type == "cuda":
        plain_ms = once_ms(lambda: cw.append(run(collapsed_scan_ref,
                                                 want_t)))
    else:
        t0 = time.perf_counter()
        cw.append(run(collapsed_scan_ref, want_t))
        plain_ms = (time.perf_counter() - t0) * 1e3
    cw = cw[0]
    got = {k: got_t[k].cpu().numpy() for k in ("Z", "active", "ZtZ", "ZtX",
                                                 "m")}
    want = {k: want_t[k].cpu().numpy() for k in got}
    if not (torch.equal(cg, ca) and all(
            torch.equal(got_t[k], again_t[k]) for k in got)):
        raise AssertionError(f"{tag}: two launches differ")

    def state_at(n):  # (active, m) entering row n, from the plain scan
        t = tensors(n, plain_dev)
        run(collapsed_scan_ref, t)
        return t["active"].cpu().numpy(), t["m"].cpu().numpy()

    ev = scan_divergence(case, want["Z"], got["Z"], state_at, sx, sa, N,
                         rest=rest)
    event = None
    if ev is not None:  # one float-boundary event, then the chains part
        n, what, margin, u = ev
        if not margin < 1e-3 * (1.0 + abs(u)):
            raise AssertionError(f"{tag}: diverges from the plain scan at "
                                 f"row {n} ({what}), margin {margin}")
        event = dict(row=n, decision=str(what), margin=margin)
    else:
        for k in ("Z", "active", "m", "ZtZ"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"{tag}: {k} differs")
        if not np.allclose(got["ZtX"], want["ZtX"], rtol=1e-5, atol=1e-4):
            raise AssertionError(f"{tag}: ZtX differs")
        if not torch.equal(cg.cpu(), cw.cpu()):
            raise AssertionError(f"{tag}: counts differ {cg} {cw}")
    err = float(np.abs(got["ZtX"] - want["ZtX"]).max()) if ev is None else None
    report = dict(
        max_abs_err=err, boundary_event=event, n_refresh=int(cg[0]),
        n_sat=int(cg[1]), ovf_row=int(cg[2]), plain_ovf_row=int(cw[2]),
        decisions_differing=int((got["Z"] != want["Z"]).sum()),
        counts_equal=bool((cg.cpu() == cw.cpu()).all()),
        born=int((want["Z"][:, case["active"] < 0.5].sum(0) > 0).sum()),
        k_live=float(want["active"].sum()), plain_ms=plain_ms,
        plain_device=str(plain_dev), Z=got["Z"])
    return report, run, tensors


def scan_variant(dev, n_rows: int, K: int, D: int, seed: int,
                 alpha: float | None = None, plain_dev="cpu",
                 flavor: str = "pallas", hold_rows: int | None = None
                 ) -> dict:
    """``hold_scan`` on a planted case (the plain scan on ``plain_dev``,
    both scans in the flip ``flavor``): one tail sub-iteration of
    ``n_rows`` rows, K tail columns, D wide, with MH births; or, with
    ``alpha``, ``n_rows`` rows of the serial sweep's scan with Gibbs
    births; then the kernel's times beside its bound. With ``hold_rows``
    the hold scans only the first hold_rows rows (the entry state still
    counts all n_rows, as a prefix of the full scan does) and the timing
    all n_rows."""
    import torch
    from _torch_cases import scan_case

    from repro_torch.kernels.collapsed_scan import collapsed_scan

    sx, sa, N = 0.5, 1.0, float(FULL["N"])
    # MH births proposed at 1% of rows (the sampler's alpha/N is ~1e-4) so
    # that the check sees them
    case = scan_case(n_rows, K, D, seed=seed, lam=0.01, alpha=alpha)
    gibbs = alpha is not None
    tag = f"collapsed_scan K={K}{' gibbs' if gibbs else ''}"
    per_row = ("Z", "X", "u_logit", "j_prop", "log_u_acc", "gumbel")
    held_case = case if hold_rows is None else {
        k: v[:hold_rows] if k in per_row else v for k, v in case.items()}
    rep, run, _ = hold_scan(dev, held_case, sx, sa, N, tag,
                            plain_dev=plain_dev, flavor=flavor)
    del rep["Z"]
    b, by = scan_bound_ms(n_rows, K, D, rep["k_live"], gibbs,
                          fast=flavor == "fast")
    # the kernel is timed scanning on from its own output
    t = {k: torch.tensor(v, device=dev) for k, v in case.items()}
    out = dict(
        shape=f"rows={n_rows} K={K} D={D}" + (
            f" gibbs alpha={alpha:g}" if gibbs else ""), **rep,
        held_rows=n_rows if hold_rows is None else hold_rows,
        free_left=K - rep["k_live"],
        **timed(lambda: run(collapsed_scan, t), ("collapsed_scan_kernel",)),
        bound_ms=b, bound_by=by)
    out["ms_per_row"] = out["ms"] / n_rows
    stamp(f"[3] collapsed_scan {out['shape']} held and timed")
    return out


def check_collapsed_scan(dev) -> dict:
    """The tail scan at the main path's tail shape (N_p rows, K_tail=8,
    D=1024), and at the grown tails of phase 7 (K_tail 16, whose carry
    still fits one block's shared memory, and 32, whose carry lives in
    global memory) on 1024 rows; then the serial sweep's scan with Gibbs
    births on COLLAPSED["hold_rows"] rows at its K_max=32 and at phase 9's wide K_max=64
    (global memory), at K=16 (shared memory, the Gumbel values through
    the ring), and at K=4 with alpha = N/4, where births are common and
    fill every free column, so that the capacity mask (j <= the free
    columns) binds."""
    n_rows, K, D = FULL["N"] // FULL["P"], FULL["K_tail"], FULL["D"]
    main = dict(name="collapsed_scan",
                **scan_variant(dev, n_rows, K, D, 31, plain_dev=dev),
                library_ms=None, library_call=None)
    main["variants"] = [scan_variant(dev, 1024, k, D, 31 + k)
                        for k in GROWTH["K_tails"][1:]]
    main["variants"] += [
        scan_variant(dev, COLLAPSED["hold_rows"], k, D, 91 + k, alpha=a)
        for k, a in ((COLLAPSED["K_max"], COLLAPSED["alpha"]),
                     (COLLAPSED["K_max_wide"], COLLAPSED["alpha"]),
                     (16, COLLAPSED["alpha"]), (4, FULL["N"] / 4))]
    return main


def stats_variant(X, Z, tag: str = "") -> dict:
    """feature_stats against its plain version in float64 (the exact
    function: a float32 sum over 32768 rows, in any order, is off by
    ~1e-3 on entries near zero, beyond atol 1e-4), ZtZ and m exact; its
    times beside its bound and the library GEMM."""
    import torch

    from repro_torch.kernels.feature_stats import (
        feature_stats,
        feature_stats_ref,
    )

    N, D = X.shape
    K = Z.shape[1]
    got = feature_stats(X, Z)
    want = feature_stats_ref(X.double(), Z.double())
    plain32 = feature_stats_ref(X, Z)
    torch.cuda.synchronize()
    for name, a, b in zip(("ZtZ", "ZtX", "m"), got, want):
        if name != "ZtX" and not torch.equal(a.double(), b):
            raise AssertionError(f"feature_stats{tag}: {name} not exact")
        if not torch.allclose(a.double(), b, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"feature_stats{tag}: {name} off by "
                                 f"{float((a.double() - b).abs().max())}")
    err = max(float((a.double() - b).abs().max()) for a, b in zip(got, want))
    err32 = max(float((a - b).abs().max()) for a, b in zip(got, plain32))
    ZX1 = torch.cat([Z, X, torch.ones((N, 1), device=X.device)], dim=1)
    Zt = Z.T.contiguous()
    nbytes = 4.0 * (N * D + N * K + K * K + K * D + K)
    nnz = float((Z != 0).sum())
    flops = nnz * (D + 1) + float((Z.sum(1) ** 2).sum())  # binary Z: adds
    b, by = bound_ms(nbytes, flops)
    return dict(
        shape=f"N={N} K={K} D={D}{tag}", max_abs_err=err,
        max_abs_err_vs_plain_f32=err32,
        **timed(lambda: feature_stats(X, Z),
                ("feature_stats_partial_kernel", "feature_stats_sum_kernel")),
        plain_ms=time_ms(lambda: feature_stats_ref(X, Z)),
        bound_ms=b, bound_by=by,
        **library(lambda: torch.matmul(Zt, ZX1)),
        library_call="torch.matmul(Z^T, [Z | X | 1])")


def sse_variant(X, Z, A, act, dt, tag: str = "") -> dict:
    """gaussian_sse on inputs of dtype ``dt`` against the plain version in
    float64 on the same (rounded) inputs, two calls bitwise equal; its
    times beside its bound and the library call."""
    import torch

    from repro_torch.kernels.gaussian_sse import gaussian_sse, gaussian_sse_ref

    rows, D = X.shape
    K = Z.shape[1]
    rtol = 1e-5 if dt == torch.float32 else 2e-2
    Xd, Zd, Ad, actd = (t.to(dt) for t in (X, Z, A, act))
    first = gaussian_sse(Xd, Zd, Ad, actd)
    if not torch.equal(first, gaussian_sse(Xd, Zd, Ad, actd)):
        raise AssertionError(f"gaussian_sse {dt}{tag}: two calls differ")
    got = float(first)
    want = float(gaussian_sse_ref(Xd.double(), Zd, Ad, actd))
    if not math.isclose(got, want, rel_tol=rtol):
        raise AssertionError(f"gaussian_sse {dt}{tag}: {got} vs {want}")
    if dt == torch.bfloat16:
        # the rounding of the inputs: the float32 plain version too
        ref32 = float(gaussian_sse_ref(Xd, Zd, Ad, actd))
        if not math.isclose(got, ref32, rel_tol=rtol):
            raise AssertionError(f"gaussian_sse bf16{tag}: {got} vs {ref32}")
    esz = 4 if dt == torch.float32 else 2
    Zm = (Zd * actd).to(dt)
    nbytes = esz * (rows * D + rows * K + K * D + K) + 4.0
    nnz = float((Z * act != 0).sum())
    flops = nnz * D + 3.0 * rows * D
    b, by = bound_ms(nbytes, flops)
    return dict(
        shape=f"N={rows} K={K} D={D} {str(dt).split('.')[-1]}{tag}",
        max_abs_err=abs(got - want), rel_err=abs(got - want) / want,
        **timed(lambda: gaussian_sse(Xd, Zd, Ad, actd),
                ("sse_mma_kernel", "sse_final_kernel")),
        plain_ms=time_ms(lambda: gaussian_sse_ref(Xd, Zd, Ad, actd)),
        bound_ms=b, bound_by=by,
        **library(lambda: torch.addmm(Xd, Zm, Ad, alpha=-1).float()
                  .square().sum()),
        # one read of X alone: the floor the fused kernel approaches
        read_x_ms=device_ms(lambda: Xd.sum(dtype=torch.float32), ("",)))


def check_stats_kernels(dev) -> list[dict]:
    """feature_stats at the sync's shape; gaussian_sse there in float32
    and bfloat16, with a real-valued Z (f32; the kernel then runs its
    third product) and at the held-out eval's N=1024 (f32)."""
    import numpy as np
    import torch

    N, K, D = SHAPE["N"], SHAPE["K"], SHAPE["D"]
    X_np, _, A_true = planted_data(N, D, 24, 0.3, 0.5, seed=21)
    rng = np.random.default_rng(22)
    X = torch.from_numpy(X_np).to(dev)
    Z = torch.from_numpy((rng.random((N, K)) < 0.3).astype(np.float32)).to(dev)
    A = torch.from_numpy(
        0.3 * rng.standard_normal((K, D), dtype=np.float32)).to(dev)
    A[:24] = torch.from_numpy(A_true).to(dev)
    act = torch.from_numpy((np.arange(K) < 40).astype(np.float32)).to(dev)
    stats = dict(name="feature_stats", **stats_variant(X, Z))
    Zr = Z * torch.from_numpy(
        rng.uniform(0.5, 1.5, (N, K)).astype(np.float32)).to(dev)
    variants = [sse_variant(X[:rows], Zv[:rows], A, act, dt, tag)
                for dt, rows, Zv, tag in (
                    (torch.float32, N, Z, ""), (torch.bfloat16, N, Z, ""),
                    (torch.float32, N, Zr, " real_z"),
                    (torch.float32, FULL["N_eval"], Z, ""))]
    sse = dict(name="gaussian_sse", **variants[0],
               library_call="torch.addmm(X, Z*active, A, alpha=-1)"
                            ".square().sum()")
    sse["variants"] = variants[1:]
    return [stats, sse]


# --------------------------------------------------------------------------
# phases 4 and 5: the main path
# --------------------------------------------------------------------------


def run_cli(tmp: Path) -> list[dict]:
    from repro_torch.launch import mcmc

    drv = mcmc.main(["--device", "cuda", "--N", "1000", "--P", "5",
                     "--K-max", "32", "--K-tail", "8", "--L", "5",
                     "--iters", "40", "--eval-every", "20",
                     "--ckpt-dir", str(tmp / "cli_ckpt"),
                     "--out", str(tmp / "cli_history.json")])
    hist = drv.history
    if [r["it"] for r in hist] != [20, 40]:
        raise AssertionError(f"CLI eval records at {[r['it'] for r in hist]}")
    for r in hist:
        if not (math.isfinite(r["joint_ll_eval"]) and math.isfinite(
                r["sigma_x"]) and 1 <= r["K"] <= 32):
            raise AssertionError(f"CLI record out of range: {r}")
    return hist


def full_data() -> tuple:
    """Phase 5's planted matrix: (X_train, X_eval, seconds to make it,
    the planted Z of the training rows, the planted feature rows A)."""
    f = FULL
    t0 = time.perf_counter()
    X, Z, A = planted_data(f["N"] + f["N_eval"], f["D"], f["K_true"], f["p"],
                           f["sigma_n"], seed=0)
    return X[:f["N"]], X[f["N"]:], time.perf_counter() - t0, Z[:f["N"]], A


def time_tail(Xs, Z, gs, K_tail: int, backend: str = "fast") -> dict:
    """One tail sub-iteration on p' (N_p rows, one collapsed_scan launch)
    from empty K_tail-wide buffers, with the row step ``backend``: host
    time around it, ended by a device sync, and its profile."""
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp.hybrid import _tail_sub_iteration

    P, N_p, _ = Xs.shape
    g = prng.generator(prng.key(1), Xs.device)
    pp = int(gs.p_prime)
    zt = torch.zeros((N_p, K_tail), device=Xs.device)
    ta = torch.zeros((K_tail,), device=Xs.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _tail_sub_iteration(Xs[pp], Z[pp], zt, ta, gs, float(P * N_p), g,
                        collapsed_backend=backend)
    torch.cuda.synchronize()
    t_tail = time.perf_counter() - t0
    return dict(tail_rows_per_s=N_p / t_tail,
                tail_ms_per_row=t_tail / N_p * 1e3,
                tail_profile=profile_tail(Xs[pp], Z[pp], gs, float(P * N_p),
                                          g, K_tail, backend))


def run_full_width(tmp: Path, gpu: str, data: tuple
                   ) -> tuple[dict, dict, tuple]:
    """Phase 5; returns (results, kernel launches of the driver's run, the
    driver's sampler and final state)."""
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp import IBPHypers, SamplerSpec
    from repro_torch.core.ibp.sweeps import uncollapsed_sweep
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import MCMCDriver

    f = FULL
    X_train, X_eval, t_data = data[:3]
    spec = SamplerSpec(P=f["P"], K_max=f["K_max"], K_tail=f["K_tail"],
                       L=f["L"], n_iters=f["iters"], eval_every=f["iters"],
                       ckpt_every=f["iters"], ckpt_dir=str(tmp / "full_ckpt"))
    torch.cuda.reset_peak_memory_stats()
    drv = MCMCDriver(X_train, spec, IBPHypers(), X_eval=X_eval, device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    gs, ss = drv.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    rec = drv.history[-1]
    if not (math.isfinite(rec["joint_ll_eval"]) and math.isfinite(
            rec["sigma_x"]) and 1 <= rec["K"] <= f["K_max"]):
        raise AssertionError(f"full-width record out of range: {rec}")
    if int(gs.overflow) != 0:
        raise AssertionError("full-width run overflowed K_max")
    peak = torch.cuda.max_memory_allocated()

    # components, timed on the final state: one sweep of all P*N_p rows,
    # one tail sub-iteration on p'
    Xs = drv.sampler.Xs
    P, N_p, D = Xs.shape
    Xf, Zf = Xs.reshape(P * N_p, D), ss.Z.reshape(P * N_p, -1)
    g = prng.generator(prng.key(1), "cuda")

    def sweep():
        uncollapsed_sweep(Xf, Zf, gs.A, gs.pi, gs.active, gs.sigma_x, g)

    t_sweep = time_ms(sweep, reps=5) / 1e3
    return dict(
        gpu=gpu, N=f["N"], D=D, K_max=f["K_max"], K_tail=f["K_tail"], P=P,
        L=f["L"], iters=f["iters"], data_seconds=t_data,
        seconds_per_iteration=t_run / f["iters"],
        sweep_rows_per_s=P * N_p / t_sweep,
        **time_tail(Xs, ss.Z, gs, f["K_tail"]),
        max_memory_allocated=peak, K=rec["K"], sigma_x=rec["sigma_x"],
        joint_ll_eval=rec["joint_ll_eval"], tail_sat=rec["tail_sat"]), \
        counts, (drv.sampler, gs, ss)


def run_growth(tmp: Path, data: tuple, dev) -> tuple[dict, dict, dict]:
    """Phase 7: restart from phase 5's checkpoint (K_max=64, it=3) under
    K_max=128 with ``k_tail_grow=2`` and a checkpoint every iteration, to
    iteration 6, with tail saturation forced at every step (each step
    adds 1 to ``tail_sat``), so that K_tail goes 8 -> 16 -> 32; then
    restore the last checkpoint under the smallest multiple of 8 that
    is >= K+ + 8 and run one iteration. Returns (results, launches of
    the growth run, the kernels at the grown widths)."""
    import numpy as np
    import torch

    from repro_torch.core.ibp import IBPHypers, SamplerSpec
    from repro_torch.core.ibp.api import Sampler
    from repro_torch.core.ibp.sweeps import _logit
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import MCMCDriver

    f, gr = FULL, GROWTH
    X_train, X_eval = data[:2]
    ckpt = str(tmp / "full_ckpt")
    spec = SamplerSpec(P=f["P"], K_max=gr["K_max"], K_tail=f["K_tail"],
                       L=f["L"], n_iters=gr["iters"], eval_every=gr["iters"],
                       ckpt_every=1, k_tail_grow=gr["k_tail_grow"],
                       ckpt_dir=ckpt)
    drv = MCMCDriver(X_train, spec, IBPHypers(), X_eval=X_eval, device=dev)
    steps = []  # one entry per iteration of the growth run
    plain_step = Sampler.step

    def saturating_step(self, gs, ss):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry = dict(it=int(gs.it), K_max=ss.Z.shape[-1],
                     K_tail=ss.Z_tail.shape[-1],
                     overflow_in=int(gs.overflow))
        gs, ss = plain_step(self, gs, ss)
        torch.cuda.synchronize()
        entry["seconds"] = time.perf_counter() - t0
        steps.append(entry)
        return dataclasses.replace(gs, tail_sat=gs.tail_sat + 1), ss

    Sampler.step = saturating_step
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        gs, ss = drv.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        Sampler.step = plain_step
    tails = [e["K_tail"] for e in steps]
    if tails != list(gr["K_tails"]):
        raise AssertionError(f"growth: K_tail per iteration {tails}, "
                             f"expected {list(gr['K_tails'])}")
    if {e["K_max"] for e in steps} != {gr["K_max"]} or \
            ss.Z.shape[-1] != gr["K_max"]:
        raise AssertionError(f"growth: Z widths {steps}, {tuple(ss.Z.shape)}")
    if steps[0]["overflow_in"] != 0 or int(gs.overflow) != 0:
        raise AssertionError(f"growth: overflow {steps[0]['overflow_in']} "
                             f"after the restart, {int(gs.overflow)} at end")
    if steps[0]["it"] != f["iters"] or int(gs.it) != gr["iters"]:
        raise AssertionError(f"growth: ran iterations {steps[0]['it']} to "
                             f"{int(gs.it)}")
    rec = drv.history[-1]
    if not (math.isfinite(rec["joint_ll_eval"]) and math.isfinite(
            rec["sigma_x"]) and 1 <= rec["K"] <= gr["K_max"]
            and rec["K_tail"] == gr["K_tails"][-1]):
        raise AssertionError(f"growth record out of range: {rec}")
    for name in MAIN_PATH:
        if counts.get(name, 0) < 1:
            raise AssertionError(f"growth: {name} was not launched ({counts})")

    # the tail at each grown width, timed as phase 5 times K_tail 8; the
    # kernels at the grown K_max on the final state, each against its
    # plain version
    Xs = drv.sampler.Xs
    P, N_p, D = Xs.shape
    tail = {k: time_tail(Xs, ss.Z, gs, k) for k in gr["K_tails"][1:]}
    Xf, Zf = Xs.reshape(P * N_p, D), ss.Z.reshape(P * N_p, -1)
    g = torch.Generator(device=dev).manual_seed(71)
    u = _logit(torch.rand(Zf.shape, generator=g, device=dev))
    kernels = dict(
        gibbs_flip=gibbs_variant(Xf, Zf, gs.A, _logit(gs.pi), gs.active, u,
                                 0.5 / gs.sigma_x**2, " grown K_max"),
        feature_stats=stats_variant(Xf, Zf, " grown K_max"),
        gaussian_sse=sse_variant(Xf, Zf, gs.A, gs.active, torch.float32,
                                 " grown K_max"))
    k_plus = int(torch.sum(gs.active))

    # shrink: the last checkpoint under the smallest multiple of 8 >= K+ + 8
    K_small = 8 * math.ceil((k_plus + 8) / 8)
    if K_small >= gr["K_max"]:
        raise AssertionError(f"growth: K+={k_plus} leaves nothing to shrink")
    small = MCMCDriver(X_train, SamplerSpec(
        P=f["P"], K_max=K_small, K_tail=f["K_tail"], L=f["L"],
        n_iters=gr["iters"] + 1, eval_every=gr["iters"] + 1, ckpt_dir=ckpt),
        IBPHypers(), X_eval=X_eval, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs2, ss2 = small.run()
    torch.cuda.synchronize()
    t_small = time.perf_counter() - t0
    rec2 = small.history[-1]
    if ss2.Z.shape[-1] != K_small or gs2.A.shape[0] != K_small \
            or int(gs2.it) != gr["iters"] + 1 \
            or not math.isfinite(rec2["joint_ll_eval"]):
        raise AssertionError(f"shrink to {K_small}: Z {tuple(ss2.Z.shape)}, "
                             f"it {int(gs2.it)}, record {rec2}")
    by_tail = {}
    for e in steps:
        by_tail.setdefault(e["K_tail"], []).append(e["seconds"])
    return dict(
        K_max=gr["K_max"], k_tail_grow=gr["k_tail_grow"],
        iterations=steps, seconds_per_iteration_by_K_tail={
            k: float(np.median(v)) for k, v in by_tail.items()},
        run_seconds=t_run, K=rec["K"], sigma_x=rec["sigma_x"],
        joint_ll_eval=rec["joint_ll_eval"], K_tail=rec["K_tail"],
        tail=tail, shrunk_K_max=K_small, shrunk_K=rec2["K"],
        shrunk_run_seconds=t_small), counts, kernels


def run_baseline(dev, data: tuple) -> tuple[dict, dict, dict]:
    """Phase 8: the serial uncollapsed baseline at full width on phase 5's
    data, K=64 all active, A seeded from the first 64 data rows + 0.01;
    BASELINE["steps"] uncollapsed_steps. Returns (results, launches, the
    sweep kernel at this shape against its plain version)."""
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp import IBPHypers, init_state, uncollapsed_step
    from repro_torch.core.ibp.sweeps import _logit
    from repro_torch.kernels import launch_counts, reset_launch_counts

    K, n = BASELINE["K"], BASELINE["steps"]
    X = torch.from_numpy(data[0]).to(dev)
    N, D = X.shape
    state = init_state(prng.key(8), N, D, K_max=K, K_init=K, device=dev)
    state = dataclasses.replace(state, A=X[:K] + 0.01)
    torch.cuda.synchronize()
    reset_launch_counts()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state = uncollapsed_step(state, X, IBPHypers())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = launch_counts()
    for name in ("gibbs_flip", "feature_stats", "gaussian_sse"):
        if counts.get(name, 0) != n:
            raise AssertionError(f"baseline: {name} launched "
                                 f"{counts.get(name, 0)} times in {n} steps")
    sx = float(state.sigma_x)
    if not (math.isfinite(sx) and sx > 0):
        raise AssertionError(f"baseline: sigma_x = {sx}")
    g = torch.Generator(device=dev).manual_seed(81)
    u = _logit(torch.rand(state.Z.shape, generator=g, device=dev))
    sweep = gibbs_variant(X, state.Z, state.A, _logit(state.pi),
                          state.active, u, 0.5 / state.sigma_x**2,
                          " all active")
    return dict(N=N, D=D, K=K, steps=n, seconds_per_step=times,
                median_seconds_per_step=statistics.median(times), sigma_x=sx,
                sigma_a=float(state.sigma_a), alpha=float(state.alpha),
                m_live=int((state.Z.sum(0) > 0.5).sum())), counts, sweep


def sigma_replay(before, after, scan_out, X) -> dict:
    """One sweep's sigma_x and sigma_a MH moves replayed from the sweep's
    own keys, on its device and from its scan's output, as
    ``collapsed._finish_sweep`` makes them: the proposal, the difference
    of the two collapsed log-likelihoods plus the log-scale Jacobian, the
    log uniform and the decision. The sampler's new sigma_x and sigma_a
    must equal the replay's bitwise."""
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp import math as ibm

    N, D = X.shape
    _, _, _, ksx, ksa = prng.split(before.key, 5)
    _, act, ZtZ, ZtX, m = scan_out[:5]
    act = act * (m > 0.5)
    ZtZ, ZtX = ZtZ * ibm.mask_outer(act), ZtX * act[:, None]
    trXtX = torch.sum(X * X)

    def cll(sx_, sa_):
        return ibm.collapsed_loglik(trXtX, ZtX, ZtZ, act, float(N), D, sx_,
                                    sa_)

    out, sx, sa = {}, before.sigma_x, before.sigma_a
    for name, key in (("x", ksx), ("a", ksa)):
        cur = sx if name == "x" else sa
        g = prng.generator(key, X.device)
        eps = torch.randn((), generator=g, dtype=cur.dtype, device=X.device)
        prop = cur * torch.exp(0.1 * eps)
        lls = (cll(prop, sa), cll(cur, sa)) if name == "x" else (
            cll(sx, prop), cll(sx, cur))
        d = lls[0] - lls[1] + torch.log(prop) - torch.log(cur)
        log_u = torch.log(torch.rand((), generator=g, dtype=cur.dtype,
                                     device=X.device))
        new = torch.where(log_u < d, prop, cur)
        got = after.sigma_x if name == "x" else after.sigma_a
        if not torch.equal(new, got):
            raise AssertionError(f"collapsed: sigma_{name} {float(got)} is "
                                 f"not the replayed move's {float(new)}")
        out[f"sigma_{name}"] = dict(
            cur=float(cur), prop=float(prop), step=float(0.1 * eps),
            delta=float(d), log_u=float(log_u), accepted=bool(log_u < d))
        if name == "x":
            sx = new
    return out


def run_collapsed(dev, data: tuple) -> tuple[dict, dict]:
    """Phase 9: the serial collapsed sampler (collapsed_sweep, Gibbs
    births, the carried scan on the card) on phase 5's data at K_max=32
    from init_state (K_init=4): one warm sweep, then COLLAPSED["sweeps"]
    timed sweeps, each launching feature_stats and collapsed_scan once and
    no other kernel; after each sweep, outside its time, its sigma moves
    are replayed (``sigma_replay``). After the last sweep the scan's
    carried ZᵀZ and m must equal those recomputed from its Z exactly
    (integer counts), and the returned Z must be the scan's, pruned. The
    kernels are then held against their plain versions on the sweep's
    own inputs: feature_stats on the last sweep's entry Z, and the scan
    over the first
    COLLAPSED["prefix_rows"] rows of the last sweep (its entry state,
    which counts all N rows, and its draws), whose Z must also equal the
    sweep's own first rows bitwise. Then one sweep at K_max=64, with
    feature_stats held on its entry and returned Z. Returns (results,
    launches of the timed sweeps)."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp import IBPHypers, collapsed_sweep, init_state
    from repro_torch.core.ibp import collapsed as coll
    from repro_torch.core.ibp import math as ibm
    from repro_torch.kernels import launch_counts, reset_launch_counts

    c = COLLAPSED
    X = torch.from_numpy(data[0]).to(dev)
    N, D = X.shape
    hyp = IBPHypers()
    # the last sweep's scan, its inputs and outputs: the carried
    # statistics, which collapsed_sweep prunes and does not return
    scans = []
    plain_scan = coll.collapsed_row_scan

    def keeping_scan(*args, **kw):
        out = plain_scan(*args, **kw)
        scans[:] = [(args, kw, out)]
        return out

    replay = []  # each sweep's sigma moves, replayed after the sweep

    coll.collapsed_row_scan = keeping_scan
    try:
        state = init_state(prng.key(9), N, D, K_max=c["K_max"],
                           K_init=c["K_init"], alpha=c["alpha"], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(c["warm"]):
            entry, state = state, collapsed_sweep(state, X, hyp, **OFF)
            replay.append(sigma_replay(entry, state, scans[0][2], X))
        torch.cuda.synchronize()
        reset_launch_counts()
        times, k_plus = [], []
        for _ in range(c["sweeps"]):
            t0 = time.perf_counter()
            entry, state = state, collapsed_sweep(state, X, hyp, **OFF)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            k_plus.append(int(state.active.sum()))
            replay.append(sigma_replay(entry, state, scans[0][2], X))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        scan_in, scan_kw, scan_out = scans[0]
        # one more sweep under the profiler: the device's busy share and
        # time by kernel
        sweep_profile = profile_call(
            lambda: collapsed_sweep(state, X, hyp, **OFF))

        wide0 = init_state(prng.key(10), N, D, K_max=c["K_max_wide"],
                           K_init=c["K_init"], alpha=c["alpha"], device=dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        wide = collapsed_sweep(wide0, X, hyp, **OFF)
        torch.cuda.synchronize()
        t_wide = time.perf_counter() - t0
        wide_counts = launch_counts()
    finally:
        coll.collapsed_row_scan = plain_scan

    n = c["sweeps"]
    for name in ("collapsed_scan", "feature_stats"):
        if counts.get(name, 0) != n or wide_counts.get(name, 0) != 1:
            raise AssertionError(
                f"collapsed: {name} launched {counts.get(name, 0)} times in "
                f"{n} sweeps, {wide_counts.get(name, 0)} in the K_max="
                f"{c['K_max_wide']} sweep")
    others = {k: v for k, v in counts.items()
              if k not in ("collapsed_scan", "feature_stats") and v}
    if others:
        raise AssertionError(f"collapsed: other kernels launched {others}")
    # carried statistics exact against the scan's Z (0/1 sums)
    Z_s, act_s, ZtZ_s, ZtX_s, m_s, n_refresh, n_sat = scan_out
    Zd = Z_s.double()
    if not (torch.equal(m_s.double(), Zd.sum(0))
            and torch.equal(ZtZ_s.double(), Zd.T @ Zd)):
        raise AssertionError("collapsed: carried m or ZtZ differ from the "
                             "scan's Z")
    if not torch.equal(state.Z, Z_s * state.active[None, :]) or \
            int(n_sat) != 0:
        raise AssertionError("collapsed: returned Z is not the scan's, "
                             "pruned, or n_sat != 0")
    sx, sa, alpha = (float(state.sigma_x), float(state.sigma_a),
                     float(state.alpha))
    if not (all(math.isfinite(v) and v > 0 for v in (sx, sa, alpha))
            and 1 <= k_plus[-1] <= c["K_max"]
            and math.isfinite(float(wide.sigma_x))):
        raise AssertionError(f"collapsed: sigma_x={sx}, sigma_a={sa}, "
                             f"alpha={alpha}, K+={k_plus}")
    # the sigma_x MH's collapsed log-likelihoods on the final state, at
    # sigma_x and at proposals exp(+0.1) and exp(-0.1) away, in float32
    # (the sampler's arithmetic) and in float64 (the rounding of the first)
    act = state.active
    ZtZ = ZtZ_s * ibm.mask_outer(act)
    ZtX = ZtX_s * act[:, None]
    trXtX = torch.sum(X * X)

    def lls(dt):
        f = lambda t: t.to(dt)  # noqa: E731
        ll = [float(ibm.collapsed_loglik(f(trXtX), f(ZtX), f(ZtZ), f(act),
                                         float(N), D, f(state.sigma_x * s_),
                                         f(state.sigma_a)))
              for s_ in (1.0, math.exp(0.1), math.exp(-0.1))]
        return ll + [ll[1] - ll[0], ll[2] - ll[0]]

    ll32, ll64 = lls(torch.float32), lls(torch.float64)
    med = statistics.median(times)

    # the kernels against their plain versions on the sweep's own inputs:
    # feature_stats on the last timed sweep's entry Z (all columns that
    # the sweep found live)
    stats = [stats_variant(X, entry.Z, " (phase 9 entry)")]
    # the scan over the first rows of the last timed sweep: its entry
    # state, which counts all N rows, its draws and its sigmas
    Z0, act0, ZtZ0, ZtX0, m0, _, sx0, sa0, draws = scan_in
    R = c["prefix_rows"]
    np_ = lambda t: t.cpu().numpy()  # noqa: E731
    case = dict(Z=np_(Z0[:R]), active=np_(act0), ZtZ=np_(ZtZ0),
                ZtX=np_(ZtX0), m=np_(m0), X=np_(X[:R]),
                u_logit=np_(draws.u_logit[:R]), gumbel=np_(draws.gumbel[:R]),
                alpha=np_(scan_kw["alpha"]))
    Zr = Z0[R:].double()
    rest = (np_(Zr.T @ Zr), np_(Zr.T @ X[R:].double()))
    t0 = time.perf_counter()
    prefix, _, _ = hold_scan(dev, case, float(sx0), float(sa0),
                             scan_kw["N"], "collapsed_scan phase 9 prefix",
                             rest=rest)
    if not np.array_equal(prefix.pop("Z"), np_(Z_s[:R])):
        raise AssertionError("collapsed: the prefix launch's Z differs from "
                             "the sweep's own first rows")
    prefix.update(shape=f"rows={R} of the K_max={c['K_max']} sweep, "
                  f"N={N} D={D} gibbs", seconds=time.perf_counter() - t0)

    # the scan kernel alone at the sweep's shape (one launch over all N
    # rows at K_max), on the final state with fresh draws, beside its bound
    m1, ZtZ1, ZtX1, _ = coll._sweep_stats(state.Z, state.active, X)
    draws1 = coll.draw_scan(N, c["K_max"], state.alpha, float(N),
                            prng.generator(prng.key(11), dev), birth="gibbs")

    def scan():
        plain_scan(state.Z, state.active, ZtZ1, ZtX1, m1, X, state.sigma_x,
                   state.sigma_a, draws1, N=float(N), alpha=state.alpha,
                   birth="gibbs")

    b, by = scan_bound_ms(N, c["K_max"], D, float(act.sum()), True)
    kernel = dict(shape=f"rows={N} K={c['K_max']} D={D} gibbs (the sweep)",
                  **timed(scan, ("collapsed_scan_kernel",), reps=1),
                  bound_ms=b, bound_by=by, k_live=float(act.sum()))
    kernel["ms_per_row"] = kernel["ms"] / N
    # feature_stats at K_max=64: the wide sweep's entry Z and its result
    stats += [stats_variant(X, wide0.Z, " (phase 9 K_max=64 entry)"),
              stats_variant(X, wide.Z, " (phase 9 K_max=64 result)")]
    return dict(
        N=N, D=D, K_max=c["K_max"], K_init=c["K_init"], sweeps=n,
        seconds_per_sweep=times, median_seconds_per_sweep=med,
        min_seconds_per_sweep=min(times), max_seconds_per_sweep=max(times),
        ms_per_row=med / N * 1e3, rows_per_s=N / med, K_plus=k_plus,
        sigma_x=sx, sigma_a=sa, alpha=alpha, n_refresh=int(n_refresh),
        sigma_moves=replay, loglik_f32=ll32, loglik_f64=ll64,
        loglik_diff_rounding=abs(ll32[3] - ll64[3]),
        max_memory_allocated=peak, wide_K_max=c["K_max_wide"],
        wide_seconds_per_sweep=t_wide, wide_ms_per_row=t_wide / N * 1e3,
        wide_K_plus=int(wide.active.sum()), sweep_profile=sweep_profile,
        scan_kernel=kernel, scan_prefix=prefix, stats=stats), counts


def packed_case(data: tuple, K_can: int, modeled: int, unexplained: int,
                seed: int, gibbs: bool) -> dict:
    """A scan input on the first PACKED["rows"] rows of phase 5's data:
    the planted rows less the features beyond ``modeled + unexplained``
    (as the tail's residual leaves out the instantiated features), the
    first ``modeled`` planted columns of Z at sorted random canonical
    indices of ``K_can``, plus a singleton column, so the ``unexplained``
    features are left to births; canonical uniforms, and Gibbs (alpha =
    PACKED["alpha"], Gumbel noise) or MH (proposals at 1% of rows)
    draws."""
    import numpy as np

    R = PACKED["rows"]
    X, Zt, A = data[0][:R], data[3][:R], data[4]
    keep = modeled + unexplained
    X = (X - Zt[:, keep:] @ A[keep:]).astype(np.float32)
    rng = np.random.default_rng(seed)
    at = np.sort(rng.choice(K_can, size=modeled + 1, replace=False))
    Z = np.zeros((R, K_can), np.float32)
    Z[:, at[:modeled]] = Zt[:, :modeled]
    Z[R // 3, at[modeled]] = 1.0  # a singleton: dropped at its row
    uu = np.clip(rng.random((R, K_can)), 1e-7, 1.0 - 1e-7)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    case = dict(Z=Z, active=(Z.sum(0) > 0).astype(np.float32),
                ZtZ=f32(Z.T @ Z), ZtX=f32(Z.T @ X), m=f32(Z.sum(0)), X=X,
                u_logit=f32(np.log(uu) - np.log1p(-uu)))
    if gibbs:
        case.update(gumbel=f32(rng.gumbel(size=(R, 5))),
                    alpha=np.float32(PACKED["alpha"]))
    else:
        case.update(j_prop=f32(rng.poisson(0.01, R)),
                    log_u_acc=f32(np.log(rng.random(R))))
    return case


def packed_variant(dev, data: tuple, K_can: int, modeled: int,
                   unexplained: int, seed: int, gibbs: bool, flavor: str,
                   B: int) -> dict:
    """``hold_scan`` on a ``packed_case`` at block ``B`` with ``flavor``,
    then the kernel's times beside its bound: scanning on from its own
    output, or, where a birth overflowed the block, from a fresh copy of
    the case each call (the rows up to ``ovf_row`` are the work, the
    copy is not a kernel)."""
    from repro_torch.kernels.collapsed_scan import collapsed_scan

    sx, sa, N = 0.5, 1.0, float(FULL["N"])
    case = packed_case(data, K_can, modeled, unexplained, seed, gibbs)
    tag = (f"collapsed_scan {flavor} B={B} of {K_can}"
           f"{' gibbs' if gibbs else ''}")
    rep, run, tensors = hold_scan(dev, case, sx, sa, N, tag, flavor=flavor,
                                  B=B)
    del rep["Z"]
    R, D = case["X"].shape
    out = dict(shape=f"rows={R} B={B} of K_can={K_can} D={D} {flavor}"
               f"{' gibbs' if gibbs else ' mh'}", flavor=flavor, B=B,
               live_in=float(case["active"].sum()), **rep)
    rows = rep["ovf_row"] + 1 if rep["ovf_row"] >= 0 else R
    b, by = scan_bound_ms(rows, B, D, rep["k_live"], gibbs,
                          fast=flavor == "fast")
    if rep["ovf_row"] >= 0:
        fn = lambda: run(collapsed_scan, tensors())  # noqa: E731
    else:
        t = tensors()
        fn = lambda: run(collapsed_scan, t)  # noqa: E731
    out.update(**timed(fn, ("collapsed_scan_kernel",)), bound_ms=b,
               bound_by=by, rows_scanned=rows)
    out["ms_per_row"] = out["ms"] / rows
    stamp(f"[10] collapsed_scan {out['shape']} held and timed")
    return out


def check_packed_scan(dev, data: tuple) -> list[dict]:
    """Phase 10's holds of the scan against its plain version, each on
    PACKED["rows"] rows of phase 5's data: the rss flip with the carried G at the
    tail's K=8 with MH births (2 of 3 modeled features unexplained);
    Gibbs births at buckets 16 (8 modeled features, 9 live) and 32 (20
    modeled, 21 live) of K_can=64, in both flavors; and a forced overflow
    at bucket 16 (13 modeled, 14 live, 2 free slots, 3 features left to
    births), where ovf_row must equal the plain scan's."""
    c = PACKED
    out = [packed_variant(dev, data, c["tail_K"], 3, 2, 41, False, "fast",
                          c["tail_K"])]
    for B, modeled in zip(c["buckets"], (8, 20)):
        for flavor in ("fast", "pallas"):
            out.append(packed_variant(dev, data, c["K_can"], modeled, 2,
                                      42 + B, True, flavor, B))
    ovf = packed_variant(dev, data, c["K_can"], 13, 3, 43, True, "fast", 16)
    if ovf["plain_ovf_row"] < 0 or ovf["ovf_row"] != ovf["plain_ovf_row"]:
        raise AssertionError(f"packed: the forced overflow reported ovf_row "
                             f"{ovf['ovf_row']}, the plain scan "
                             f"{ovf['plain_ovf_row']}")
    out.append(ovf)
    return out


def run_packed(dev, data: tuple, phase5: tuple) -> tuple[dict, dict]:
    """Phase 10: the packed collapsed carry. The scan held against its
    plain version (``check_packed_scan``); then ``collapsed_sweep`` with
    ``k_live_buckets="on"`` under backends "fast" and "pallas" on phase
    5's data at K_max=64 from phase 9's wide start (K_init=4, the same
    key): one warm sweep (its seg_log: the repacks from bucket 8 up),
    PACKED["sweeps"] timed, one profiled, then one ``"off"`` sweep and
    one ``"on"`` sweep timed from that same final state and draws; each
    sweep's buckets are checked against ``pick_bucket`` of its entry K+.
    Then one "off" and one "on" sweep from a state whose K+ stays below
    K_max (20 planted columns, sigma_x at the data's noise).
    Last, phase 5's final state stepped and its tail timed under each
    collapsed backend. Returns (results, launches of the timed sweeps)."""
    import statistics as st_

    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp import IBPHypers, collapsed_sweep, init_state
    from repro_torch.core.ibp import collapsed as coll
    from repro_torch.core.ibp import math as ibm
    from repro_torch.kernels import launch_counts, reset_launch_counts

    c = PACKED
    holds = check_packed_scan(dev, data)
    X = torch.from_numpy(data[0][:c["sweep_rows"]]).to(dev)
    N, D = X.shape
    hyp = IBPHypers()
    buckets = ibm.live_buckets(c["K_max"])
    counts: dict[str, int] = {}
    sweeps = {}

    def one(state, backend, k_live="on"):
        seg = []
        k_in = int(state.active.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collapsed_sweep(state, X, hyp, backend=backend,
                              k_live_buckets=k_live, seg_log=seg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if k_live == "on" and seg[0] != (
                ibm.pick_bucket(buckets, k_in, coll.PACK_HEADROOM), 0):
            raise AssertionError(f"packed {backend}: seg_log {seg} from "
                                 f"K+={k_in}")
        Zb = out.Z
        if not (torch.all((Zb == 0) | (Zb == 1))
                and not Zb[:, out.active < 0.5].any()
                and math.isfinite(float(out.sigma_x))
                and math.isfinite(float(out.alpha))):
            raise AssertionError(f"packed {backend}: bad state after a "
                                 f"sweep (sigma_x {float(out.sigma_x)})")
        return out, dict(seconds=dt, seg_log=seg, K_plus_in=k_in,
                         K_plus=int(out.active.sum()))

    for backend in ("fast", "pallas"):
        state = init_state(prng.key(10), N, D, K_max=c["K_max"],
                           K_init=c["K_init"], alpha=c["alpha"], device=dev)
        warm = []
        for _ in range(c["warm"]):
            state, rec = one(state, backend)
            warm.append(rec)
        reset_launch_counts()
        timed_ = []
        for _ in range(c["sweeps"]):
            state, rec = one(state, backend)
            timed_.append(rec)
        for k, v in launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        if counts.get("collapsed_scan", 0) < c["sweeps"]:
            raise AssertionError(f"packed: collapsed_scan launched "
                                 f"{counts} in {c['sweeps']} sweeps")
        profile = profile_call(lambda: collapsed_sweep(
            state, X, hyp, backend=backend))
        _, off = one(state, backend, "off")
        _, on = one(state, backend, "on")
        sec = [r["seconds"] for r in timed_]
        med = st_.median(sec)
        stamp(f"[10] {backend}: the packed sweeps")
        sweeps[backend] = dict(
            warm=warm, timed=timed_, median_seconds_per_sweep=med,
            ms_per_row=med / N * 1e3, profile=profile,
            same_state_off_seconds=off["seconds"],
            same_state_on_seconds=on["seconds"],
            same_state_bucket=on["seg_log"][0][0])
    others = {k: v for k, v in counts.items()
              if k not in ("collapsed_scan", "feature_stats") and v}
    if others or counts.get("feature_stats", 0) != 2 * c["sweeps"]:
        raise AssertionError(f"packed: launches {counts}")

    # the packing's gain where K+ stays below K_max: 20 of the 24 planted
    # columns of Z at sorted random indices of K_max=64 and sigma_x at the
    # data's noise (K+ 20-24: bucket 32), one "off" and one "on" sweep
    # from that state (the same draws) under each backend
    rng = np.random.default_rng(12)
    at = np.sort(rng.choice(c["K_max"], size=20, replace=False))
    Zs = torch.zeros((N, c["K_max"]), device=dev)
    Zs[:, torch.from_numpy(at).to(dev)] = torch.from_numpy(
        data[3][:N, :20]).to(dev)
    settled0 = dataclasses.replace(
        init_state(prng.key(12), N, D, K_max=c["K_max"], K_init=0,
                   alpha=c["alpha"], sigma_x=FULL["sigma_n"], device=dev),
        Z=Zs, active=(Zs.sum(0) > 0).float())
    settled = {}
    for backend in ("fast", "pallas"):
        off_s, off = one(settled0, backend, "off")
        on_s, on = one(settled0, backend, "on")
        settled[backend] = dict(
            off_seconds=off["seconds"], on_seconds=on["seconds"],
            on_seg_log=on["seg_log"], K_plus_in=on["K_plus_in"],
            K_plus_off=off["K_plus"], K_plus_on=on["K_plus"],
            decisions_differing=int((off_s.Z != on_s.Z).sum()))
        stamp(f"[10] {backend}: off and on from K+ 20")

    # phase 5's iteration and tail under each collapsed backend, from its
    # final state (the defaults: "fast" and k_live_buckets "on")
    sampler, gs, ss = phase5
    Xs = sampler.Xs
    hybrid = {}
    for backend in ("fast", "pallas"):
        s = sampler.with_spec(sampler.spec.replace(collapsed_backend=backend))
        t_it = []
        for _ in range(c["iters"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.step(gs, ss)
            torch.cuda.synchronize()
            t_it.append(time.perf_counter() - t0)
        tail = time_tail(Xs, ss.Z, gs, FULL["K_tail"], backend)
        hybrid[backend] = dict(seconds_per_iteration=st_.median(t_it),
                               iterations=t_it, **tail)
    return dict(N=N, D=D, K_max=c["K_max"], K_init=c["K_init"],
                holds=holds, sweeps=sweeps, settled=settled,
                hybrid=hybrid), counts


def profile_call(fn) -> dict:
    """torch.profiler over one call of ``fn``: its wall time (ended by a
    device sync), the device's busy share of it, the device time of its
    kernels by name (the six longest) and the count of kernels it
    launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in kernel_events(p):
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_s=wall, busy_share=busy / wall,
                kernels=len(kernel_events(p)),
                top_kernels_us=[(n, round(us, 1)) for n, us in top])


def profile_tail(X_p, Z_p, gs, N_g: float, g, K_tail: int,
                 backend: str = "fast") -> dict | None:
    """torch.profiler over one tail sub-iteration of all N_p rows of p':
    wall and device time per row, kernels per row, host syncs per row
    (the CUDA runtime's synchronising calls the profiler records, less
    the window's own closing synchronize), and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.ibp.hybrid import _tail_sub_iteration

    rows = X_p.shape[0]
    zt = torch.zeros((rows, K_tail), device="cuda")
    ta = torch.zeros((K_tail,), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        _tail_sub_iteration(X_p, Z_p, zt, ta, gs, N_g, g,
                            collapsed_backend=backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = kernel_events(p)
    if not ev:
        return None
    runtime = [e.name for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("cuda")]
    # runtime calls that wait for the device, less the window's closing
    # torch.cuda.synchronize() (recorded as cudaDeviceSynchronize); None
    # where the profiler records no CUDA runtime call at all
    syncs = (sum(1 for n in runtime if n in ("cudaStreamSynchronize",
                                             "cudaEventSynchronize",
                                             "cudaMemcpy"))
             if any("LaunchKernel" in n for n in runtime) else None)
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e6
    by_name: dict[str, float] = {}
    for e in ev:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(rows=rows, wall_ms_per_row=wall / rows * 1e3,
                device_ms_per_row=busy / rows * 1e3,
                kernels_per_row=len(ev) / rows, busy_share=busy / wall,
                host_syncs=syncs,
                host_syncs_per_row=None if syncs is None else syncs / rows,
                top_kernels_us=[(n, round(us, 1)) for n, us in top])


# --------------------------------------------------------------------------
# phase 11: posterior-predictive serving
# --------------------------------------------------------------------------


def run_harvest(tmp: Path, data: tuple) -> tuple[dict, dict, object]:
    """Phase 11's harvest: MCMCDriver at phase 5's widths with
    ``harvest_every=1`` and ``harvest_burn=0.2`` for SERVING["iters"]
    iterations. The harvest's host work (``add_state``: the copy of the
    state and the live block's factor; ``save_bank``) is timed after a
    device sync, so that it does not include the iteration it waits for.
    Then the saved npz, loaded, must equal the built bank bitwise.
    Returns (results, kernel launches of the run, the bank)."""
    import torch

    from repro_torch.core.ibp import IBPHypers, SampleBank, SamplerSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import MCMCDriver

    f, c = FULL, SERVING
    X_train, X_eval = data[:2]
    spec = SamplerSpec(P=f["P"], K_max=f["K_max"], K_tail=f["K_tail"],
                       L=f["L"], n_iters=c["iters"], eval_every=c["iters"],
                       ckpt_every=c["iters"], ckpt_dir=str(tmp / "serve_ckpt"),
                       harvest_every=c["harvest_every"],
                       harvest_burn=c["harvest_burn"],
                       bank_path=str(tmp / "bank.npz"))
    drv = MCMCDriver(X_train, spec, IBPHypers(), X_eval=X_eval, device="cuda")
    host = {"add_state": [], "save_bank": []}

    def timed_host(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host[name].append(time.perf_counter() - t0)
            return out
        return call

    drv.bank_builder.add_state = timed_host("add_state",
                                            drv.bank_builder.add_state)
    drv.save_bank = timed_host("save_bank", drv.save_bank)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    drv.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = launch_counts()
    bank = drv.bank
    S_want = c["iters"] - int(c["harvest_burn"] * c["iters"])
    if bank.S != S_want or len(host["add_state"]) != S_want:
        raise AssertionError(f"harvest: S={bank.S}, expected {S_want}")
    back = SampleBank.load(spec.bank_path, device="cuda")
    for fld in dataclasses.fields(SampleBank):
        a, b = getattr(bank, fld.name), getattr(back, fld.name)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"harvest: the loaded bank's {fld.name} "
                                 f"differs from the built one")
    rec = drv.history[-1]
    if not (math.isfinite(rec["joint_ll_eval"]) and 1 <= rec["K"]):
        raise AssertionError(f"harvest record out of range: {rec}")
    harvest_s = sum(host["add_state"]) + sum(host["save_bank"])
    return dict(
        iters=c["iters"], S=bank.S, K_bucket=bank.K, D=bank.D,
        K_plus=[int(v) for v in bank.active.sum(1).tolist()],
        its=bank.it.tolist(), seconds_per_iteration=t_run / c["iters"],
        harvest_seconds_per_iteration=harvest_s / c["iters"],
        add_state_seconds=host["add_state"],
        save_bank_seconds=host["save_bank"], loaded_bank_equal=True,
        K=rec["K"], sigma_x=rec["sigma_x"],
        joint_ll_eval=rec["joint_ll_eval"]), counts, bank


def hold_scorer(bank, X_np, mask_np, seed: int) -> dict:
    """The batched scorer on the card against the same call on the CPU:
    the same bank, rows, mask and pre-drawn uniforms. A (sample, row)
    chain whose draws differ must hold a float-boundary event (|logit -
    u| or |y - 1/2| < 1e-4, ``scorer_divergence``); on the others probs
    within 1e-4 and row log-likelihoods within 1e-5 relative."""
    import numpy as np
    import torch
    from _torch_cases import scorer_divergence

    from repro_torch.core.ibp import predict

    c = SERVING
    n_sw, B = c["n_sweeps"], X_np.shape[0]
    rng = np.random.default_rng(seed)
    u = rng.random((bank.S, n_sw, bank.K, B), dtype=np.float32)
    cpu = dataclasses.replace(bank, **{f.name: getattr(bank, f.name).cpu()
                                       for f in dataclasses.fields(bank)})
    out = {}
    t = {}
    for name, b in (("cuda", bank), ("cpu", cpu)):
        dev = b.A.device
        args = [None if a is None else torch.from_numpy(a).to(dev)
                for a in (X_np, mask_np, u)]
        if name == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = predict._score_bank(b, *args, n_sw, n_sw // 2)
        out[name] = [r.cpu().numpy() for r in res]
        t[name] = time.perf_counter() - t0
    (pg, Zg, lg), (pc, Zc, lc) = out["cuda"], out["cpu"]
    fields = {f: getattr(cpu, f).numpy() for f in
              ("A", "pi", "active", "sigma_x", "chol_f")}
    events, n_bits = scorer_divergence(fields, X_np, mask_np, u, n_sw, Zc, Zg)
    same = np.ones(lc.shape, bool)
    for s, b_, _ in events:
        same[s, b_] = False
    dprob = float(np.abs(pg[same] - pc[same]).max())
    drel = float((np.abs(lg[same] - lc[same]) / np.abs(lc[same])).max())
    if not (dprob <= 1e-4 and drel <= 1e-5):
        raise AssertionError(f"scorer hold: max |dprobs| {dprob} (tol 1e-4), "
                             f"max rel |dll| {drel} (tol 1e-5)")
    return dict(rows=B, masked=mask_np is not None, bits_differing=n_bits,
                boundary_events=[dict(sample=s, row=r, margin=m)
                                 for s, r, m in events],
                decisions=int(bank.active.sum()) * B * n_sw,
                max_abs_dprobs=dprob, dprobs_tol=1e-4,
                max_rel_dll=drel, dll_rel_tol=1e-5,
                card_seconds=t["cuda"], cpu_seconds=t["cpu"])


def check_enumeration(dev) -> dict:
    """encode with SERVING["enum_sweeps"] sweeps against exact_posterior's
    marginals on the card, for a bank of one sample of 12 planted
    features at D=1024 (bucket 16). exact_posterior runs on the sample's
    live block (its first 12 rows of A, pi and active): its 2^K
    enumeration holds a (2^K, B, D) temporary (134 MB at K=12, B=8,
    D=1024). The RB estimate averages 32 kept conditional probabilities
    in [0, 1]: its standard error is at most 0.5 / sqrt(32) = 0.088, and
    the tolerance is 4 of them."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp import predict

    c = SERVING
    K, D, B = c["enum_K"], FULL["D"], c["enum_rows"]
    rng = np.random.default_rng(61)
    A = np.zeros((FULL["K_max"], D), np.float32)
    A[:K] = c["enum_scale"] * rng.standard_normal((K, D))
    act = (np.arange(FULL["K_max"]) < K).astype(np.float32)
    bb = predict.BankBuilder(FULL["K_max"])
    bb.add(A, 0.3 * act, act, c["enum_sigma"], 1.0, 2.0)
    bank = bb.build(dev)
    Z = (rng.random((B, K)) < 0.3).astype(np.float32)
    X = (Z @ A[:K] + c["enum_sigma"] * rng.standard_normal((B, D))).astype(
        np.float32)
    probs = predict.encode(bank, X, prng.key(62), n_sweeps=c["enum_sweeps"])
    marg, _, _ = predict.exact_posterior(bank.A[0, :K], bank.pi[0, :K],
                                         bank.active[0, :K],
                                         bank.sigma_x[0], X)
    kept = c["enum_sweeps"] - c["enum_sweeps"] // 2
    tol = 4 * 0.5 / math.sqrt(kept)
    err = (probs[0, :, :K] - marg).abs()
    dead = float(probs[0, :, K:].abs().max())
    if not (float(err.max()) < tol and dead == 0.0):
        raise AssertionError(f"encode vs exact_posterior: max err "
                             f"{float(err.max())} (tol {tol}), dead "
                             f"columns {dead}")
    return dict(K_bucket=bank.K, K_live=K, D=D, rows=B,
                n_sweeps=c["enum_sweeps"], kept_sweeps=kept,
                max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
                tol=tol, marginal_range=[float(marg.min()),
                                         float(marg.max())])


def serve_ops(bank, X_eval, ops: tuple[str, ...]) -> dict:
    """serve_ibp.serve once for each of ``ops`` on SERVING["requests"]
    requests of 1..max_request held-out planted rows (impute with 25% of
    each row missing), at the CLI's batch and n_sweeps; then three
    full-batch dispatches of the op under torch.profiler (kernels per
    dispatch, the device's busy share), and its peak device memory."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.launch import serve_ibp

    c = SERVING
    out = {}
    Xb = X_eval[:c["batch"]]
    for i, op in enumerate(ops):
        reqs = serve_ibp.synth_requests(
            c["requests"], c["max_request"], bank.D, seed=70 + i,
            missing=c["missing"] if op == "impute" else 0.0, X=X_eval)
        torch.cuda.reset_peak_memory_stats()
        responses, stats = serve_ibp.serve(bank, reqs, op, c["batch"],
                                           c["n_sweeps"], seed=80 + i)
        peak = torch.cuda.max_memory_allocated()
        for (rows, _), resp in zip(reqs, responses):
            n = resp.shape[-2] if op == "encode" else resp.shape[0]
            if n != rows.shape[0] or not np.all(np.isfinite(resp)):
                raise AssertionError(f"serve {op}: bad response")
        fn = serve_ibp.make_op(bank, op, c["n_sweeps"])
        mask = (np.random.default_rng(90).random(Xb.shape) >= (
            c["missing"] if op == "impute" else 0.0)).astype(np.float32)
        prof = profile_call(lambda: [fn(Xb, mask, prng.key(91 + j))
                                     for j in range(3)])
        out[op] = dict(stats, max_memory_allocated=peak,
                       dispatch_rows=c["batch"],
                       launches_per_dispatch=prof["kernels"] / 3,
                       dispatch_wall_s=prof["wall_s"] / 3,
                       dispatch_busy_share=prof["busy_share"],
                       dispatch_top_kernels_us=prof["top_kernels_us"])
    return out


def naive_vs_batched(bank, X_eval) -> tuple[dict, dict, dict]:
    """predictive_loglik_naive (a loop over the S samples, n_sweeps of
    uncollapsed_sweep each: S x n_sweeps gibbs_flip launches) against
    predictive_loglik on the same bank and rows, host clock ended by the
    fetch of the result, medians of SERVING["naive_reps"] calls; then the
    sweep kernel at the naive scorer's shape (rows from Z=0 at the bank's
    K bucket) against its plain version. Returns (results, the naive
    call's launches, the kernel variant)."""
    import statistics as st_

    import torch

    from repro_torch import prng
    from repro_torch.core.ibp import predict
    from repro_torch.core.ibp.sweeps import _logit
    from repro_torch.kernels import launch_counts, reset_launch_counts

    c = SERVING
    X = torch.from_numpy(X_eval[:c["batch"]]).cuda()
    key = prng.key(95)
    predict.predictive_loglik_naive(bank, X, key).cpu()  # first call
    reset_launch_counts()
    predict.predictive_loglik_naive(bank, X, key).cpu()
    counts = launch_counts()
    if counts.get("gibbs_flip", 0) != bank.S * c["n_sweeps"]:
        raise AssertionError(f"naive scorer: gibbs_flip launched "
                             f"{counts.get('gibbs_flip')} times for "
                             f"{bank.S} x {c['n_sweeps']} sweeps")
    times = {}
    for name, fn in (("naive", predict.predictive_loglik_naive),
                     ("batched", predict.predictive_loglik)):
        ts = []
        for _ in range(c["naive_reps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(bank, X, key, n_sweeps=c["n_sweeps"]).cpu()
            ts.append(time.perf_counter() - t0)
        times[name] = st_.median(ts)
    g = torch.Generator(device="cuda").manual_seed(96)
    Z0 = torch.zeros((X.shape[0], bank.K), device="cuda")
    u = _logit(torch.rand(Z0.shape, generator=g, device="cuda"))
    sweep = gibbs_variant(X, Z0, bank.A[0], _logit(bank.pi[0]),
                          bank.active[0], u, 0.5 / bank.sigma_x[0]**2,
                          " from Z=0 (naive scorer)")
    return dict(rows=X.shape[0], S=bank.S, n_sweeps=c["n_sweeps"],
                naive_seconds=times["naive"],
                batched_seconds=times["batched"],
                naive_over_batched=times["naive"] / times["batched"],
                naive_gibbs_flip_launches=counts.get("gibbs_flip", 0)), \
        counts, sweep


def planted_bank(data: tuple, dev):
    """A bank at the K+ the data supports: SERVING["planted_S"] samples
    of phase 5's planted model itself (its 24 feature rows plus 0.01
    N(0,1) each, pi 0.3, sigma_x at the data's noise 0.5), bucket 32 of
    K_max=64."""
    import numpy as np

    from repro_torch.core.ibp import predict

    A_true = data[4]
    K, D = A_true.shape
    rng = np.random.default_rng(67)
    act = (np.arange(FULL["K_max"]) < K).astype(np.float32)
    bb = predict.BankBuilder(FULL["K_max"])
    for s in range(SERVING["planted_S"]):
        A = np.zeros((FULL["K_max"], D), np.float32)
        A[:K] = A_true + 0.01 * rng.standard_normal((K, D))
        bb.add(A, FULL["p"] * act, act, FULL["sigma_n"], 1.0, 3.0, it=s)
    return bb.build(dev)


def run_cli_serving(tmp: Path) -> dict:
    """The two CLIs' ``main`` in this process, as ``python -m`` runs them
    (a process of its own would add about 10 s of start on the card's
    host): repro_torch.launch.mcmc harvests a bank on Cambridge data,
    then repro_torch.launch.serve_ibp --smoke serves it with --op loglik
    (both on the card, their default)."""
    import io

    from repro_torch.launch import mcmc, serve_ibp

    bank = tmp / "cli11" / "bank.npz"
    calls = [
        (mcmc.main, ["--N", "1000", "--P", "5", "--K-max", "32", "--iters",
                     "20", "--eval-every", "10", "--harvest-every", "2",
                     "--harvest-burn", "0.5", "--ckpt-dir",
                     str(tmp / "cli11"), "--bank-path", str(bank), "--out",
                     str(tmp / "cli11" / "h.json")]),
        (serve_ibp.main, ["--bank", str(bank), "--op", "loglik",
                          "--smoke"])]
    outs = []
    t0 = time.perf_counter()
    for (fn, argv), want in zip(calls, ("sample bank (5 samples) -> ",
                                        "smoke OK")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        out = buf.getvalue()
        if want not in out:
            raise AssertionError(f"{fn.__module__}: no '{want}' line:\n"
                                 f"{out[-2000:]}")
        outs.append([ln for ln in out.splitlines()
                     if want in ln or ln.startswith(("op=", "bank:"))])
    return dict(lines=outs, seconds=time.perf_counter() - t0)


def run_serving(dev, data: tuple) -> tuple[dict, dict, object]:
    """Phase 11. Returns (results, kernel launches of the harvest run and
    the naive scorer's calls, the harvested bank)."""
    import numpy as np

    from repro_torch.launch import serve_ibp

    c = SERVING
    X_eval = data[1]
    out = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        out["harvest"], counts, bank = run_harvest(tmp, data)
        out["harvest"]["seconds"] = time.perf_counter() - t0
        rows = X_eval[:c["hold_rows"]]
        miss = (np.random.default_rng(63).random(rows.shape)
                >= c["missing"]).astype(np.float32)
        out["holds"] = [hold_scorer(bank, rows, None, 64),
                        hold_scorer(bank, rows, miss, 65)]
        out["enumeration"] = check_enumeration(dev)
        out["serve"] = serve_ops(bank, X_eval, serve_ibp.OPS)
        out["naive"], naive_counts, sweep = naive_vs_batched(bank, X_eval)
        planted = planted_bank(data, dev)
        out["planted"] = dict(
            K_bucket=planted.K, S=planted.S,
            serve=serve_ops(planted, X_eval, ("loglik",)))
        out["planted"]["naive"], planted_counts, planted_sweep = \
            naive_vs_batched(planted, X_eval)
        out["cli"] = run_cli_serving(tmp)
    for k in set(naive_counts) | set(planted_counts):
        counts[k] = (counts.get(k, 0) + naive_counts.get(k, 0)
                     + planted_counts.get(k, 0))
    out["gibbs_flip_naive"] = [sweep, planted_sweep]
    return out, counts, bank


# --------------------------------------------------------------------------
# phase 12: C independent chains on one card
# --------------------------------------------------------------------------


def run_multichain(tmp: Path, data: tuple) -> tuple[dict, dict, dict]:
    """Phase 12's driver runs: ``MCMCDriver`` with driver="multichain",
    n_chains=C at phase 5's widths for 3 iterations (phase 5's protocol:
    eval and checkpoint at the end), resumed from that checkpoint to
    iteration 19 (R-hat and ESS over the 16 iterations after the
    restore), then resumed for one iteration with stale_sync=1. The tail
    of all C chains is one collapsed_scan launch a sub-iteration, so the
    3 iterations launch it L x 3 times, and the stale iteration 2 L
    times. Returns (results, launches of the 3 iterations, launches of
    the stale iteration)."""
    import torch

    from repro_torch.core.ibp import IBPHypers, SamplerSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import MCMCDriver

    f, mc = FULL, MULTI
    C, L = mc["C"], f["L"]
    X_train, X_eval = data[:2]

    def drive(spec):
        drv = MCMCDriver(X_train, spec, IBPHypers(), X_eval=X_eval,
                         device="cuda")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        gs, ss = drv.run()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        rec = drv.history[-1]
        if not (math.isfinite(rec["joint_ll_eval"]) and all(
                math.isfinite(v) for v in rec["sigma_x_chains"]) and all(
                1 <= k <= f["K_max"] for k in rec["K_chains"])
                and len(rec["K_chains"]) == C):
            raise AssertionError(f"multichain record out of range: {rec}")
        if int(gs.overflow.max()) != 0 or gs.key.shape != (C, 2):
            raise AssertionError("multichain run overflowed K_max or lost "
                                 "its chain axis")
        return t, rec, launch_counts(), gs

    spec = SamplerSpec.for_driver(
        "multichain", n_chains=C, P=f["P"], K_max=f["K_max"],
        K_tail=f["K_tail"], L=L, n_iters=mc["iters"],
        eval_every=mc["iters"], ckpt_every=mc["iters"],
        ckpt_dir=str(tmp / "multi_ckpt"))
    torch.cuda.reset_peak_memory_stats()
    t_run, rec, counts, _ = drive(spec)
    peak = torch.cuda.max_memory_allocated()
    if counts.get("collapsed_scan") != L * mc["iters"]:
        raise AssertionError(
            f"multichain: collapsed_scan launched "
            f"{counts.get('collapsed_scan')} times in {mc['iters']} "
            f"iterations, expected L x iterations = {L * mc['iters']}")
    missing = [n for n in MAIN_PATH if counts.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"multichain run launched no {missing}")
    n2 = mc["resume_iters"]
    t_resume, rec2, _, gs = drive(spec.replace(n_iters=n2, eval_every=n2,
                                               ckpt_every=n2))
    for k in ("sigma_x_rhat", "sigma_x_ess", "K_rhat", "K_ess"):
        if k not in rec2:
            raise AssertionError(f"multichain eval record lacks {k}")
    t_stale, rec3, stale_counts, _ = drive(spec.replace(
        n_iters=n2 + 1, eval_every=n2 + 1, ckpt_every=n2 + 1, stale_sync=1))
    if stale_counts.get("collapsed_scan") != 2 * L:
        raise AssertionError(
            f"stale iteration: collapsed_scan launched "
            f"{stale_counts.get('collapsed_scan')} times, expected 2 L")
    return dict(
        C=C, N=f["N"], D=f["D"], K_max=f["K_max"], K_tail=f["K_tail"],
        P=f["P"], L=L, iters=mc["iters"],
        seconds_per_iteration=t_run / mc["iters"],
        resumed_to=n2, resumed_seconds_per_iteration=t_resume / (
            n2 - mc["iters"]),
        stale_iteration_seconds=t_stale, max_memory_allocated=peak,
        record=rec, resumed_record=rec2, stale_record=rec3,
        it=gs.it.tolist()), counts, stale_counts


def multi_cases(n_rows: int, K: int, D: int, C: int, seed: int) -> list:
    """C planted scan cases (``scan_case``), one a chain: each chain its
    own rows and draws; MH births proposed at 1% of rows, as phase 3's."""
    from _torch_cases import scan_case

    return [scan_case(n_rows, K, D, seed=seed + c, lam=0.01)
            for c in range(C)]


SCAN_FIELDS = ("Z", "active", "ZtZ", "ZtX", "m", "X", "u_logit", "j_prop",
               "log_u_acc")


def chained_inputs(dev, cases: list) -> tuple[dict, object, object]:
    """The chained scan's inputs on the card: every field of ``cases``
    stacked on a leading chain axis, and sx, sa a chain."""
    import numpy as np
    import torch

    st = {k: torch.tensor(np.stack([c[k] for c in cases]), device=dev)
          for k in SCAN_FIELDS}
    C = len(cases)
    return (st, torch.full((C,), 0.5, device=dev),
            torch.full((C,), 1.0, device=dev))


def hold_chained(dev, n_rows: int, K: int, D: int, C: int, seed: int
                 ) -> dict:
    """The chained collapsed_scan (one launch, C blocks) in the tail's
    default rss flavor: each chain held against the plain scan
    (``hold_scan``: its single-chain launch must make the plain scan's
    decisions, a float-boundary event aside) and each chain of the
    chained launch bitwise equal to that chain's single-chain launch
    (Z, active, m, ZᵀZ, ZᵀX and the counts)."""
    import torch

    from repro_torch.kernels.collapsed_scan import collapsed_scan

    sx, sa, N = 0.5, 1.0, float(FULL["N"])
    kw = dict(N=N, refresh_every=64, drift_tol=1e-2, flavor="fast")
    cases = multi_cases(n_rows, K, D, C, seed)
    st, sxs, sas = chained_inputs(dev, cases)
    counts = collapsed_scan(*(st[k] for k in SCAN_FIELDS), sxs, sas, **kw)
    reps = []
    for c, case in enumerate(cases):
        rep, run, tensors = hold_scan(dev, case, sx, sa, N,
                                      f"collapsed_scan chain {c} of {C} "
                                      f"K={K}", flavor="fast")
        t = tensors()
        one = run(collapsed_scan, t)
        if not (torch.equal(counts[c], one) and all(
                torch.equal(st[k][c], t[k])
                for k in ("Z", "active", "m", "ZtZ", "ZtX"))):
            raise AssertionError(f"chained collapsed_scan K={K}: chain {c} "
                                 f"differs from its single-chain launch")
        del rep["Z"]
        reps.append(rep)
    return dict(
        shape=f"C={C} rows={n_rows} K={K} D={D} fast",
        decisions_differing=sum(r["decisions_differing"] for r in reps),
        boundary_events=[r["boundary_event"] for r in reps],
        counts_equal=all(r["counts_equal"] for r in reps),
        chains_equal_single_launch=True,
        plain_ms=sum(r["plain_ms"] for r in reps),
        plain_device=reps[0]["plain_device"],
        k_live=[r["k_live"] for r in reps],
        n_refresh=[r["n_refresh"] for r in reps],
        n_sat=[r["n_sat"] for r in reps],
        max_abs_err=max((r["max_abs_err"] for r in reps
                         if r["max_abs_err"] is not None), default=None))


def time_chained(dev, n_rows: int, K: int, D: int, Cs: tuple, seed: int
                 ) -> list[dict]:
    """The chained launch timed at each C of ``Cs`` on C planted cases
    (the kernel scanning on from its own output, as phase 3 times it):
    device ms (profiler), call ms, ms a row, and the bound: C times the
    single-chain bound (``scan_bound_ms``, rss form) at the chains' mean
    live columns after the timing."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.collapsed_scan import collapsed_scan

    kw = dict(N=float(FULL["N"]), refresh_every=64, drift_tol=1e-2,
              flavor="fast")
    cases = multi_cases(n_rows, K, D, max(Cs), seed)
    out = []
    for C in Cs:
        st, sxs, sas = chained_inputs(dev, cases[:C])

        def call():
            return collapsed_scan(*(st[k] for k in SCAN_FIELDS), sxs, sas,
                                  **kw)

        reset_launch_counts()
        t = timed(call, ("collapsed_scan_kernel",), MULTI["reps"])
        calls = launch_counts()["collapsed_scan"]
        k_live = float(st["active"].sum(-1).mean())
        b, by = scan_bound_ms(n_rows, K, D, k_live, gibbs=False, fast=True)
        out.append(dict(shape=f"C={C} rows={n_rows} K={K} D={D} fast", C=C,
                        **t, ms_per_row=t["ms"] / n_rows, bound_ms=C * b,
                        bound_by=by, k_live=k_live,
                        launches_per_call=calls / (2 * MULTI["reps"] + 2),
                        library_ms=None))
    return out


def run_chains(dev, data: tuple) -> tuple[dict, dict, dict]:
    """Phase 12: the multichain driver runs, then the chained scan held
    and timed. Returns (results, launches of the 3 iterations, launches
    of the stale iteration)."""
    mc, D = MULTI, FULL["D"]
    with tempfile.TemporaryDirectory() as tmpdir:
        drive, counts, stale_counts = run_multichain(Path(tmpdir), data)
    holds = [hold_chained(dev, mc["hold_rows"], K, D, mc["C"], 400 + K)
             for K in mc["hold_K"]]
    n_p = FULL["N"] // FULL["P"]
    timing = (time_chained(dev, n_p, mc["hold_K"][0], D, mc["time_C"], 500)
              + time_chained(dev, mc["hold_rows"], mc["hold_K"][1], D,
                             mc["time_C_global"], 600))
    return dict(drive=drive, holds=holds, timing=timing), counts, \
        stale_counts


# --------------------------------------------------------------------------
# phase 13: the data-parallel layout on P ranks
# --------------------------------------------------------------------------


def state_np(gs) -> dict:
    """A HybridGlobal's fields as numpy arrays (``interop`` takes them
    back onto a device)."""
    return {f: v.cpu().numpy().copy() for f, v in vars(gs).items()}


def rank_iterations(x_path: str, z_path: str, gs_np: dict, kw: dict,
                    syncs: tuple[str, ...], iters: int, stale: bool,
                    warm: bool, score: dict | None = None) -> dict:
    """Phases 13 and 14 on one rank of the group (``parallel.spawn``),
    under ``SamplerSpec(**kw)`` (a distributed layout): from the canonical
    state (Z of ``z_path`` reshaped to kw["P"] shards, and for each chain
    of a chains="mesh" layout the same, empty tails, ``gs_np``, chain-
    batched under the mesh), ``iters`` iterations under each sync of
    ``syncs``, each with its time, its launches, its collectives (in all
    and over the chain axis) and the device time of its tail (CUDA events
    around each tail sub-iteration, where this rank runs one); the state
    after the first; under "fused", the SSE identity beside gaussian_sse
    on the last state, then one stale pass when ``stale``. With ``warm``,
    one untimed iteration first (its result dropped): a process's first
    iteration loads the kernel libraries and creates its library
    handles. With ``score`` (phase 14), ``make_sharded_scorer`` over the
    data axis on the bank at score["bank"]: the scores of score["X"]
    under score["key"] and the median time of score["reps"] calls."""
    import numpy as np
    import torch

    from repro_torch import parallel, prng
    from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
    from repro_torch.core.ibp import hybrid as thy
    from repro_torch.interop import from_reference
    from repro_torch.kernels import launch_counts, reset_launch_counts

    clock = dict(enter=time.time())
    w = parallel.world()
    X = np.load(x_path, mmap_mode="c")
    Zc = np.load(z_path)
    Zc = Zc.reshape(kw["P"], -1, Zc.shape[-1])
    P, N_p, _ = Zc.shape
    lead = (kw["n_chains"],) if kw.get("chains") == "mesh" else ()
    ss_np = dict(Z=np.broadcast_to(Zc, lead + Zc.shape),
                 Z_tail=np.zeros(lead + (P, N_p, kw["K_tail"]), np.float32),
                 tail_active=np.zeros(lead + (P, kw["K_tail"]), np.float32))

    def wait():
        if w.device.type == "cuda":
            torch.cuda.synchronize(w.device)

    # the device time of each tail sub-iteration this rank runs
    tails = []
    chain_tails = thy._chain_tails

    def timed_tails(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = chain_tails(*a, **k)
        ev[1].record()
        tails.append(ev)
        return out

    if w.device.type == "cuda":
        thy._chain_tails = timed_tails

    def timed_call(fn):
        wait()
        reset_launch_counts()
        parallel.reset_collective_counts()
        tails.clear()
        t0 = time.perf_counter()
        out = fn()
        wait()
        return out, dict(seconds=time.perf_counter() - t0,
                         launches=launch_counts(),
                         collectives=parallel.collective_counts(),
                         collectives_chains=parallel.collective_counts(
                             "chains"),
                         collective_seconds=sum(
                             parallel.collective_seconds().values()),
                         tail_ms=sum(a.elapsed_time(b) for a, b in tails))

    out = dict(rank=w.rank, backend=w.backend, device=str(w.device),
               clock=clock)

    def all_reduce_ms(n: int, group) -> float:
        """One all-reduce of n floats over the data axis with the device
        idle and every rank at a barrier before it: the collective's own
        cost (median of 10, after one)."""
        t = torch.zeros((n,), device=w.device)
        times = []
        for _ in range(11):
            wait()
            parallel.barrier()
            t0 = time.perf_counter()
            parallel.all_reduce_sum(t, group=group)
            wait()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:]) * 1e3

    for sync in syncs:
        s = build_sampler(SamplerSpec(sync=sync, **kw), IBPHypers(), X)
        out.update(chain=s.chain, shard=s.shard)
        gs, ss = from_reference(gs_np, ss_np, device=w.device)
        gs, ss = s.from_canonical_global(gs), s.from_canonical(ss)
        data = None if s.shard is None else s.mesh.group("data")
        if sync == syncs[0] and data is not None:
            # the fused payload's size, and one float
            K, Kt = kw["K_max"], kw["K_tail"]
            out["all_reduce_ms"] = {
                n: all_reduce_ms(n, data)
                for n in (K * K + K * X.shape[1] + K + Kt + 2, 1)}
        clock.setdefault("built", time.time())
        if warm and sync == syncs[0]:
            s.step(gs, ss)
            wait()
        clock.setdefault("warm", time.time())
        steps = []
        for i in range(iters):
            pp = int(gs.p_prime)
            (gs, ss), rec = timed_call(lambda: s.step(gs, ss))
            steps.append(dict(rec, p_prime=pp))
            if i == 0:
                first = dict(Z=ss.Z.reshape(-1, ss.Z.shape[-1]).bool()
                             .cpu().numpy(), gs=state_np(gs))
        run = dict(steps=steps, first=first, last=state_np(gs))
        if sync == "fused":
            st = thy.local_stats(s.Xs, ss.Z)
            ZtZ, ZtX, xx = parallel.all_reduce_sum(
                st["ZtZ"], st["ZtX"], torch.sum(s.Xs * s.Xs)[None],
                group=data)
            run["sse_identity"] = float(thy.sse_identity(
                xx[0], ZtZ, ZtX, gs.A, gs.active))
            run["sse_kernel"] = float(parallel.all_reduce_sum(
                thy.local_sse(s.Xs, ss.Z, gs.A, gs.active), group=data))
            if stale:
                pp = int(gs.p_prime)
                _, rec = timed_call(lambda: s.stale(gs, ss))
                run["stale"] = dict(rec, p_prime=pp)
        out[sync] = run
    if score is not None:
        from repro_torch.core.ibp import SampleBank, make_sharded_scorer

        fn = make_sharded_scorer(SampleBank.load(score["bank"], w.device),
                                 s.mesh, axis="data",
                                 n_sweeps=score["n_sweeps"])
        key = prng.key(score["key"])
        got = fn(score["X"], key)  # the first call: the scorer's warm-up
        times = []
        for _ in range(score["reps"]):
            wait()
            parallel.barrier()
            t0 = time.perf_counter()
            fn(score["X"], key)
            wait()
            times.append(time.perf_counter() - t0)
        out["score"] = dict(scores=got.cpu().numpy(),
                            seconds=statistics.median(times))
    thy._chain_tails = chain_tails
    clock["done"] = time.time()
    return out


def _rel_gap(got, want) -> float:
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    return gap / scale if scale else gap


def lm_mesh_rank(s: dict) -> dict:
    """Phase 18 on one rank of the shared spawn (the module docstring
    and LM_MESH say what it runs); rank 0 also computes the unsharded
    holds and returns the gaps, every rank its step walls, collectives,
    peak memory and slices' shapes."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import parallel
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.interop import reference_leaves
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_caches, lm, transformer
    from repro_torch.models.modules import tree_map
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.parallel import mesh as pmesh

    clock = dict(enter=time.time())
    w = parallel.world()
    dev, rank0 = w.device, w.rank == 0
    mesh = parallel.make_mesh(s["shape"], ("data", "model"))
    reset_launch_counts()
    out = dict(rank=w.rank, coords=mesh.coords)

    def wait():
        torch.cuda.synchronize(dev)
        parallel.barrier()

    def placed(cfg, mode):
        """init_model(seed) drawn on the card and sharded, one rank at a
        time (the MoE layer is 6.2 GB whole)."""
        model = None
        for r in range(w.size):
            if r == w.rank:
                model = transformer.init_model(s["seed"], cfg, device=dev)
                pbytes = 2 * sum(p.numel() for p in model.parameters())
                pspecs = pmesh.resolve_param_specs(
                    transformer.param_specs(model),
                    dict(model.named_parameters()), mesh, mode=mode,
                    param_bytes=pbytes)
                parallel.shard_model(model, mesh, pspecs)
                torch.cuda.empty_cache()
            wait()
        return model

    def leaf_shardings(model, cfg):
        names = {id(p): n for n, p in model.named_parameters()}
        return names, reference_leaves(model, cfg)

    def whole_on_rank0(t, n, layout):
        """Parameter ``n``'s tensor ``t`` (this rank's slice) whole, in
        float32, on rank 0's card (None elsewhere): the port's
        ``gather_tensor`` on host copies, so no rank holds a whole copy
        on the card. A check's gathers are not the step's: the counts
        are reset after them."""
        whole = parallel.gather_tensor(t.detach().float().cpu(),
                                       layout[n].spec, mesh)
        return whole.to(dev) if rank0 else None

    def gap_on_rank0(t, n, layout, want, pieces=8):
        """``_rel_gap`` of parameter ``n``'s whole tensor (``t`` this
        rank's slice) against rank 0's ``want`` (None elsewhere), gathered
        a piece at a time along a dim every rank holds whole, so that no
        rank's host holds a whole expert slab at once."""
        spec = tuple(layout[n].spec) + (None,) * t.dim()
        free = next((d for d in range(t.dim())
                     if spec[d] is None and t.shape[d] >= pieces), None)
        parts = [t] if free is None else t.chunk(pieces, free)
        wants = want.chunk(pieces, free) if rank0 and free is not None \
            else [want] * len(parts)
        gap = 0.0
        for part, w_ in zip(parts, wants):
            got = whole_on_rank0(part, n, layout)
            if rank0:
                gap = max(gap, float((got - w_).abs().max()))
        if rank0:
            scale = float(want.abs().max())
            return gap / scale if scale else gap
        return None

    def by_kind_group():
        return {g or "all": {k: v for k, v in
                             parallel.collective_counts(g).items() if v}
                for g in (None, "data", "model", "world")}, \
            {k: round(v, 4) for k, v in
             parallel.collective_seconds().items() if v}

    # (a) smollm-135m, bf16 at the training CLI's defaults
    cfg = get_config(s["arch"])
    B, S = s["batch"], s["seq"]
    data = SyntheticLM(cfg.vocab, S + 1, B, seed=s["seed"])

    def batch_of(i):
        t = torch.from_numpy(data.batch(i)["tokens"]).long().to(dev)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    class FirstGrads:
        """The CLI's AdamW, keeping its first update's gradients (the
        reference's leaves) by parameter name."""

        def __init__(self, model, opt=None):
            self.opt = opt or AdamW(lr=cosine_schedule(s["lr"], 20, 200))
            self.names = {id(p): n for n, p in model.named_parameters()}
            self.grads = None

        def init(self, leaves):
            return self.opt.init(leaves)

        def update(self, leaves, grads, state, **kw):
            if self.grads is None:
                self.grads = {}
                for path, leaf in leaves.items():
                    gs = grads[path] if isinstance(leaf, list) \
                        else [grads[path]]
                    ps = leaf if isinstance(leaf, list) else [leaf]
                    self.grads.update({self.names[id(p)]: g
                                       for p, g in zip(ps, gs)})
            return self.opt.update(leaves, grads, state, **kw)

    model = placed(cfg, "train")
    out["wq"] = dict(local=tuple(model.layers[0].attn.wq.shape),
                     full=model.mesh_layout["layers.0.attn.wq"].shape,
                     spec=model.mesh_layout["layers.0.attn.wq"].spec,
                     sum=float(model.layers[0].attn.wq.double().sum()))
    specs = pmesh.act_specs(mesh, seq_len=S, batch=B, mode="train")
    opt = FirstGrads(model)
    state = opt.init(reference_leaves(model, cfg))
    step = lm.make_train_step(cfg, opt, specs)
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for i in range(s["steps"]):
        wait()
        parallel.reset_collective_counts()
        t0 = time.perf_counter()
        model, state, met = step(model, state, batch_of(i))
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts, secs = by_kind_group()
        steps.append(dict(loss=float(met["loss"]), wall=wall,
                          collectives=counts, seconds=secs))
    out["bf16"] = dict(steps=steps,
                       peak=torch.cuda.max_memory_allocated(dev))
    clock["bf16"] = time.time()
    # rank 0: the same steps unsharded from the same weights, and the
    # first batch's float32 gradient; the first gradients' gaps (to each
    # other and to float32) and the gap of the weights' change over the
    # steps (sharded against unsharded, in norm)
    ref = None
    if rank0:
        ref = transformer.init_model(s["seed"], cfg, device=dev)
        w0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
        _, _, g32 = lm.loss_and_grads(ref, batch_of(0), dataclasses.replace(
            cfg, dtype="float32"))
        uopt = FirstGrads(ref)
        ust = uopt.init(reference_leaves(ref, cfg))
        ustep = lm.make_train_step(cfg, uopt)
        ulosses = []
        for i in range(s["steps"]):
            ref, ust, um = ustep(ref, ust, batch_of(i))
            ulosses.append(float(um["loss"]))
        out["bf16"]["unsharded_losses"] = ulosses
        gu = uopt.grads

    def norm_gap(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    gaps = {}
    for n, p in model.named_parameters():
        g = whole_on_rank0(opt.grads[n], n, model.mesh_layout)
        wgt = whole_on_rank0(p, n, model.mesh_layout)
        if rank0:
            want = gu[n].float()
            moved = dict(ref.named_parameters())[n].float() - w0[n]
            gaps[n] = (norm_gap(g, want), _rel_gap(g, want),
                       norm_gap(wgt - w0[n], moved),
                       norm_gap(g, g32[n]), norm_gap(want, g32[n]))
    parallel.reset_collective_counts()
    del opt, model, state, ref
    if rank0:
        out["bf16"]["grad_gaps"] = gaps
        del gu, uopt, g32, w0
    torch.cuda.empty_cache()
    wait()
    clock["bf16_hold"] = time.time()

    # (b) float32 holds at hold_B x hold_S: one make_train_step on the
    # mesh (the loss, its gradients, the AdamW update it applies) against
    # the unsharded loss and gradients and the unsharded AdamW on the
    # step's own gradients
    cfg32 = dataclasses.replace(cfg, dtype="float32", remat=False)
    rng = np.random.default_rng(s["seed"] + 1)
    hb = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (s["hold_B"], s["hold_S"] + 1))).to(dev)}
    model = placed(cfg32, "train")
    specs = pmesh.act_specs(mesh, seq_len=s["hold_S"], batch=s["hold_B"],
                            mode="train")
    opt = FirstGrads(model, AdamW(lr=1e-3))
    st = opt.init(reference_leaves(model, cfg32))
    parallel.reset_collective_counts()
    model, st, met = lm.make_train_step(cfg32, opt, specs)(model, st, hb)
    out["f32"] = dict(loss=float(met["loss"]),
                      collectives=by_kind_group()[0])
    whole_g = {n: whole_on_rank0(g, n, model.mesh_layout)
               for n, g in opt.grads.items()}
    new = {n: whole_on_rank0(p, n, model.mesh_layout)
           for n, p in model.named_parameters()}
    parallel.reset_collective_counts()
    if rank0:
        ref = transformer.init_model(s["seed"], cfg32, device=dev)
        w0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
        lu, _, gu = lm.loss_and_grads(ref, hb, cfg32)
        out["f32"]["unsharded_loss"] = float(lu)
        out["f32"]["grad_gaps"] = {n: _rel_gap(whole_g[n], gu[n])
                                   for n in gu}
        rn, rl = leaf_shardings(ref, cfg32)
        uopt = AdamW(lr=1e-3)
        ust = uopt.init(rl)
        uper = {path: [whole_g[rn[id(p)]] for p in leaf]
                if isinstance(leaf, list) else whole_g[rn[id(leaf)]]
                for path, leaf in rl.items()}
        uopt.update(rl, uper, ust)
        # the weights' gap, of their max |w| and of the update's max |change|
        out["f32"]["adam_gaps"] = {
            n: (_rel_gap(new[n], p.detach()),
                _rel_gap(new[n] - w0[n], p.detach() - w0[n]))
            for n, p in ref.named_parameters()}
        del ref, gu, w0
    del model, opt, whole_g, new, st
    torch.cuda.empty_cache()
    wait()
    clock["f32"] = time.time()

    # (c) decode on the mesh (serve specs; caches stored sharded)
    DB, n = s["decode_B"], s["decode_steps"]
    model = placed(cfg32, "serve")
    toks = torch.from_numpy(np.random.default_rng(s["seed"] + 2).integers(
        0, cfg.vocab, (DB, n))).to(dev)
    specs = pmesh.act_specs(mesh, seq_len=1, batch=DB, mode="decode")
    caches = init_caches(cfg32, DB, n, dev)
    cspecs = pmesh.layer_cache_specs(cfg32, caches, mesh)
    caches = tree_map(lambda t, sp: parallel.shard_tensor(t, sp, mesh),
                      caches, cspecs)
    out["cache_local"] = tuple(tuple(t.shape) for t in caches[0])
    decode = lm.make_decode_step(cfg32, specs, cspecs)
    got, walls = [], []
    for i in range(n):
        wait()
        t0 = time.perf_counter()
        nxt, caches = decode(model, {"tokens": toks[:, i:i + 1]}, caches)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        got.append(nxt.cpu().numpy())
    out["decode"] = dict(walls=walls, tokens=np.stack(got, 1))
    del model, caches
    torch.cuda.empty_cache()
    if rank0:
        ref = transformer.init_model(s["seed"], cfg32, device=dev)
        uc = init_caches(cfg32, DB, n, dev)
        want, gaps = [], []
        for i in range(n):
            with torch.inference_mode():
                logits, _, uc = transformer.model_apply(
                    ref, {"tokens": toks[:, i:i + 1]}, cfg32, mode="decode",
                    caches=uc)
            top2 = logits[:, -1].topk(2, dim=-1).values
            want.append(logits[:, -1].argmax(-1).cpu().numpy())
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        out["decode"]["unsharded"] = np.stack(want, 1)
        out["decode"]["top2_gap"] = np.stack(gaps, 1)
        del ref, uc
        torch.cuda.empty_cache()
    wait()
    clock["decode"] = time.time()

    # (d) the MoE config's one layer at full width, a2a against gather
    mcfg = get_config(s["moe"])
    mcfg = dataclasses.replace(
        mcfg, n_layers=1, dtype="float32", moe_impl="a2a", remat=False,
        capacity_factor=mcfg.n_experts / mcfg.top_k)
    mb = {"tokens": torch.from_numpy(np.random.default_rng(
        s["seed"] + 3).integers(0, mcfg.vocab, (s["moe_B"],
                                                s["moe_S"] + 1))).to(dev)}
    model = placed(mcfg, "train")
    clock["moe_placed"] = time.time()
    specs = pmesh.act_specs(mesh, seq_len=s["moe_S"], batch=s["moe_B"],
                            mode="train")
    torch.cuda.reset_peak_memory_stats(dev)
    wait()
    parallel.reset_collective_counts()
    t0 = time.perf_counter()
    loss, met, grads = lm.loss_and_grads(model, mb, mcfg, 0.01, specs)
    torch.cuda.synchronize(dev)
    counts, secs = by_kind_group()
    out["moe"] = dict(loss=float(loss), aux=float(met["aux"]),
                      wall=time.perf_counter() - t0, collectives=counts,
                      seconds=secs, peak=torch.cuda.max_memory_allocated(dev))
    layout = model.mesh_layout
    del model
    torch.cuda.empty_cache()
    wait()
    clock["moe_step"] = time.time()
    if rank0:
        ref = transformer.init_model(
            s["seed"], dataclasses.replace(mcfg, moe_impl="gather"),
            device=dev)
        lu, mu, gu = lm.loss_and_grads(ref, mb, mcfg)
        out["moe"]["unsharded"] = dict(loss=float(lu), aux=float(mu["aux"]))
        del ref
    gaps = {}
    for n, g in grads.items():
        gap = gap_on_rank0(g, n, layout, gu[n] if rank0 else None)
        if rank0:
            gaps[n] = gap
    parallel.reset_collective_counts()
    if rank0:
        out["moe"]["grad_gaps"] = gaps
        del gu
    del grads
    torch.cuda.empty_cache()
    out["launches"] = launch_counts()
    clock["done"] = time.time()
    out["clock"] = clock
    return out


def check_lm_mesh(ranks: list, clock: dict) -> dict:
    """Phase 18's holds on its ranks' results (``lm_mesh_rank``); raises
    on any that fails. Returns what ``log_lm_mesh`` prints."""
    import numpy as np

    s = LM_MESH
    r0 = ranks[0]
    bad = []
    b = r0["bf16"]
    for i, (st, u) in enumerate(zip(b["steps"], b["unsharded_losses"])):
        if abs(st["loss"] - u) > s["bf16_loss_rtol"] * abs(u):
            bad.append(f"bf16 step {i} loss {st['loss']} vs {u}")
        if any(r["bf16"]["steps"][i]["loss"] != st["loss"] for r in ranks):
            bad.append(f"bf16 step {i}: the ranks' losses differ")
    g_worst = max((v[0], n) for n, v in b["grad_gaps"].items())
    g_elem = max((v[1], n) for n, v in b["grad_gaps"].items())
    w_worst = max((v[2], n) for n, v in b["grad_gaps"].items())
    # each leaf's bf16 gradient as close to the float32 one as the
    # unsharded step's (twice its gap, or bf16_rtol)
    g32 = max((v[3] / max(2 * v[4], s["bf16_rtol"]), n, v[3], v[4])
              for n, v in b["grad_gaps"].items())
    fall = (b["unsharded_losses"][0] - b["unsharded_losses"][-1]) / abs(
        b["unsharded_losses"][0])
    if s["bf16_loss_rtol"] > fall / 10:
        bad.append(f"the bf16 loss limit {s['bf16_loss_rtol']} would pass "
                   f"steps that move nothing (the loss falls {fall})")
    if g32[0] > 1 or w_worst[0] > s["moved_rel"]:
        bad.append(f"bf16 gradient {g32} or weight change {w_worst} gap")
    f = r0["f32"]
    f_loss = abs(f["loss"] - f["unsharded_loss"]) / abs(f["unsharded_loss"])
    f_grad = max((v, n) for n, v in f["grad_gaps"].items())
    f_adam = max((v[0], n) for n, v in f["adam_gaps"].items())
    f_moved = max((v[1], n) for n, v in f["adam_gaps"].items())
    if f_loss > s["loss_rtol"] or f_grad[0] > s["grad_rel"] or \
            f_adam[0] > s["adam_rel"] or f_moved[0] > s["adam_moved_rel"]:
        bad.append(f"float32 loss {f_loss}, gradient {f_grad}, AdamW "
                   f"{f_adam}, change {f_moved}")
    d = r0["decode"]
    near = d["top2_gap"] < s["tie_gap"]
    differ = (d["tokens"] != d["unsharded"])
    if (differ & ~near).any() or any(
            not np.array_equal(r["decode"]["tokens"], d["tokens"])
            for r in ranks):
        bad.append(f"decode tokens {d['tokens'].tolist()} vs "
                   f"{d['unsharded'].tolist()}")
    wq = [r["wq"] for r in ranks]
    spread = len({(q["sum"], q["local"]) for q in wq})
    if spread < 2 or wq[0]["local"] == wq[0]["full"]:
        bad.append(f"wq not spread over the ranks: {wq}")
    m = r0["moe"]
    m_loss = abs(m["loss"] - m["unsharded"]["loss"]) / abs(
        m["unsharded"]["loss"])
    m_aux = abs(m["aux"] - m["unsharded"]["aux"]) / abs(
        m["unsharded"]["aux"])
    m_grad = max((v, n) for n, v in m["grad_gaps"].items())
    if m_loss > s["loss_rtol"] or m_aux > s["loss_rtol"] or \
            m_grad[0] > s["grad_rel"]:
        bad.append(f"MoE a2a vs gather: loss {m_loss}, aux {m_aux}, "
                   f"gradient {m_grad}")
    if not m["collectives"]["model"].get("all_to_all"):
        bad.append(f"MoE: no all-to-all over model: {m['collectives']}")
    launched = {k: v for r in ranks for k, v in r["launches"].items() if v}
    if launched:
        bad.append(f"phase 18 launched a kernel: {launched}")
    if bad:
        raise AssertionError("phase 18: " + "; ".join(bad))
    return dict(ranks=ranks, clock=clock, g_worst=g_worst, g_elem=g_elem,
                g32=g32, w_worst=w_worst,
                f_loss=f_loss, f_grad=f_grad, f_adam=f_adam,
                f_moved=f_moved, fall=fall,
                near=int(near.sum()), differ=int(differ.sum()),
                m_loss=m_loss, m_aux=m_aux, m_grad=m_grad)


def log_lm_mesh(v: dict, smi: str) -> None:
    s, ranks = LM_MESH, v["ranks"]
    r0 = ranks[0]
    b = r0["bf16"]
    walls = [[round(st["wall"], 3) for st in r["bf16"]["steps"]]
             for r in ranks]
    log(f"[18] {s['arch']} whole on a {s['shape']} (data, model) mesh, "
        f"{len(ranks)} ranks on cuda:0 over gloo, bf16 on float32 masters, "
        f"remat, B={s['batch']} S={s['seq']}: {s['steps']} sharded steps, "
        f"losses {[round(st['loss'], 6) for st in b['steps']]} (unsharded "
        f"{[round(x, 6) for x in b['unsharded_losses']]}, limit "
        f"{s['bf16_loss_rtol']} relative, the unsharded loss falls "
        f"{v['fall']:.4g}); step walls by rank {walls} s; peak "
        f"device memory by rank {[r['bf16']['peak'] for r in ranks]} "
        f"bytes; gpu: {smi}")
    for i, st in enumerate(b["steps"]):
        log(f"[18] bf16 step {i} on rank 0: collectives by group "
            f"{st['collectives']}, host seconds {st['seconds']}")
    log(f"[18] bf16 first gradient: against the unsharded step's, worst "
        f"leaf {v['g_worst'][1]} {v['g_worst'][0]:.3g} of its norm, largest "
        f"element gap {v['g_elem'][1]} {v['g_elem'][0]:.3g} of its max |g|; "
        f"against float32's, the worst leaf for its limit {v['g32'][1]}: "
        f"{v['g32'][2]:.3g} of its norm, the unsharded bf16 step's "
        f"{v['g32'][3]:.3g} (limit: twice that, or {s['bf16_rtol']}); "
        f"the weights' change over {s['steps']} steps against the "
        f"unsharded change: worst {v['w_worst'][1]} at "
        f"{v['w_worst'][0]:.3g} of its norm (limit {s['moved_rel']}; a "
        f"step that moves nothing is 1)")
    f = r0["f32"]
    log(f"[18] float32 B={s['hold_B']} S={s['hold_S']}: loss "
        f"{f['loss']:.8f} vs unsharded {f['unsharded_loss']:.8f} "
        f"({v['f_loss']:.3g} relative, limit {s['loss_rtol']}); worst "
        f"gradient {v['f_grad'][1]} {v['f_grad'][0]:.3g} of its max |g| "
        f"(limit {s['grad_rel']}); one make_train_step's weights against "
        f"the unsharded AdamW on its gradients, worst {v['f_adam'][1]} "
        f"{v['f_adam'][0]:.3g} of max |w| (limit {s['adam_rel']}), "
        f"{v['f_moved'][1]} {v['f_moved'][0]:.3g} of the update's max "
        f"|change| (limit {s['adam_moved_rel']}); the step's collectives "
        f"{f['collectives']}")
    q = r0["wq"]
    log(f"[18] layers.0.attn.wq {q['full']} as {q['spec']}: {q['local']} "
        f"on each rank, {len({r['wq']['sum'] for r in ranks})} distinct "
        f"slices over {len(ranks)} ranks")
    d = r0["decode"]
    log(f"[18] decode, float32, B={s['decode_B']}, {s['decode_steps']} "
        f"teacher-forced steps on caches stored sharded (a layer's k on a "
        f"rank: {r0['cache_local'][0]}): argmaxes {d['tokens'].tolist()}, "
        f"{v['differ']} differ from the unsharded decode's ({v['near']} "
        f"near ties under {s['tie_gap']}); step walls "
        f"{[round(t, 3) for t in d['walls']]} s")
    m = r0["moe"]
    log(f"[18] {s['moe']} one layer, float32, a2a on {s['moe_B']} x "
        f"{s['moe_S']} tokens vs the gather dispatch at capacity E/top_k: "
        f"loss {v['m_loss']:.3g} relative, aux {v['m_aux']:.3g}, worst "
        f"gradient {v['m_grad'][1]} {v['m_grad'][0]:.3g} of its max |g|; "
        f"forward+backward {m['wall']:.3f} s, collectives by group "
        f"{m['collectives']}, host seconds {m['seconds']}; peak device "
        f"memory by rank {[r['moe']['peak'] for r in ranks]} bytes")
    log(f"[18] the spawn's clock (s after it started): {v['clock']}; "
        f"launches of the five kernels: none")


def rank_jobs(jobs: list) -> list:
    """On one rank of ``parallel.spawn``: each (function, arguments) of
    ``jobs`` in turn, in the one process group, and their results in
    order. Phases 13 and 14 share their 8 ranks, and their worlds of one
    rank share a process: on the card's host a rank's start (its imports
    and its CUDA context) takes about 10 s, one rank after another."""
    return [fn(*args) for fn, args in jobs]


def spawn_clock(ranks: list, t0: float, tag: str,
                returned: float | None = None) -> dict:
    """Where a spawn's seconds went (wall clock from ``t0``, just before
    the spawn): the slowest rank's entry into ``rank_iterations`` (the
    first job's: the process start, its imports and the group's set-up),
    its sampler built, its untimed iteration done, its work done; and the
    spawn's return (``returned``, default now)."""
    out = {k: round(max(r["clock"][k] for r in ranks) - t0, 2)
           for k in ("enter", "built", "warm", "done")}
    out["returned"] = round((time.time() if returned is None else returned)
                            - t0, 2)
    stamp(f"{tag} spawn clock {out}")
    return out


def spawn_layouts(tmp: Path, data: tuple, phase5: tuple, bank) -> dict:
    """Phases 13, 14 and 18's rank work in one spawn: phase 5's P ranks on
    cuda:0 (gloo) run phase 13's shardmap job, then phase 14's C x P mesh
    job (the same world: C·P = P), then phase 18's LM on a (4, 2) mesh;
    then one rank in an NCCL world of one runs phase 13's and phase 14's
    jobs at P=1. Returns each phase's ranks, its world of one's result
    and the spawns' clocks."""
    import torch

    from repro_torch import parallel

    if MESH["C"] * MESH["P"] != FULL["P"] or \
            math.prod(LM_MESH["shape"]) != FULL["P"]:
        raise AssertionError("phases 13, 14 and 18 share one world of ranks")
    jobs = [(rank_iterations, shardmap_job(tmp, data, phase5)),
            (rank_iterations, mesh_job(tmp, data, phase5, bank)),
            (lm_mesh_rank, (LM_MESH,))]
    ones = [(rank_iterations, shardmap_one_job(tmp, data, phase5)),
            (drive_mesh, mesh_one_job(tmp, data))]
    torch.cuda.empty_cache()
    t0, w0 = time.perf_counter(), time.time()
    ranks = parallel.spawn(rank_jobs, FULL["P"], jobs, device="cuda:0",
                           timeout_s=900)
    t_spawn, w1 = time.perf_counter() - t0, time.time()
    t1 = time.perf_counter()
    one = parallel.spawn(rank_jobs, 1, ones, device="cuda:0",
                         timeout_s=600)[0]
    t_one = time.perf_counter() - t1
    stamp(f"[13-14] the world of one rank: {t_one:.1f} s")
    return dict(
        ranks13=[r[0] for r in ranks], ranks14=[r[1] for r in ranks],
        ranks18=[r[2] for r in ranks],
        one13=one[0], one14=one[1], spawn_seconds=t_spawn,
        one_spawn_seconds=t_one,
        clock13=spawn_clock([r[0] for r in ranks], w0, "[13]", w1),
        clock14=spawn_clock([r[1] for r in ranks], w0, "[14]", w1),
        clock18={k: round(max(r[2]["clock"][k] for r in ranks) - w0, 2)
                 for k in ranks[0][2]["clock"]})


def shard_uniforms(gs, p: int, shape: tuple, dev):
    """The logit uniforms of shard p's first sweep, as the sampler derives
    them: fold_in(fold_in(key, p), 0), split, the first half."""
    import torch

    from repro_torch import prng
    from repro_torch.core.ibp.sweeps import _logit

    key = prng.split(prng.fold_in(prng.fold_in(gs.key, p), 0), 2)[0]
    return _logit(torch.rand(shape, generator=prng.generator(key, dev),
                             device=dev))


def sweep_blocks(sampler, gs, ss) -> dict:
    """The layouts' only difference before the sync, held directly: the
    first sub-iteration's sweep as the vmap layout runs it (one
    gibbs_flip call on all P·N_p rows) and as each rank runs it (one call
    on its N_p rows), on the same rows, state and per-shard uniforms.
    Each decision that differs must sit at a float-boundary event,
    |logit - u| < SHARDMAP["boundary"] in float64."""
    import torch

    from repro_torch.core.ibp.sweeps import _logit
    from repro_torch.kernels.gibbs_flip import gibbs_flip_core

    Xs = sampler.Xs
    P, N_p, D = Xs.shape
    K = ss.Z.shape[-1]
    u = torch.cat([shard_uniforms(gs, p, (N_p, K), Xs.device)
                   for p in range(P)])
    args = (_logit(gs.pi), gs.active)
    inv2s2 = 0.5 / gs.sigma_x**2
    Xf, Zf = Xs.reshape(P * N_p, D), ss.Z.reshape(P * N_p, K)
    whole = gibbs_flip_core(Xf, Zf, gs.A, *args, u, inv2s2)
    blocks = torch.cat([gibbs_flip_core(
        Xs[p], ss.Z[p], gs.A, *args, u[p * N_p:(p + 1) * N_p], inv2s2)
        for p in range(P)])
    diff = (whole != blocks).nonzero().tolist()
    events = []
    for n in sorted({n for n, _ in diff}):
        k = min(kk for nn, kk in diff if nn == n)
        m = gibbs_margin(Xf, Zf, whole, gs.A, args[0], inv2s2, u, n, k)
        if not m < SHARDMAP["boundary"]:
            raise AssertionError(
                f"shardmap sweep: decision ({n},{k}) differs between one "
                f"call and the rank's block away from the boundary "
                f"(|logit-u|={m})")
        events.append(n)
    return dict(decisions_differing=len(diff), boundary_events=len(events),
                shards_with_events=sorted({n // N_p for n in events}))


def rel_A(tag: str, got, want) -> tuple[float, float]:
    """max |got - want| of A, and its share of max |want|, which must be
    within SHARDMAP["A_rtol"]."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    dA = float(np.abs(got - want).max())
    rel = dA / max(float(np.abs(want).max()), 1e-30)
    if not rel <= SHARDMAP["A_rtol"]:
        raise AssertionError(f"{tag}: A differs by {dA} ({rel:.3g} of "
                             f"max |A|)")
    return dA, rel


def rel_sigma_x(tag: str, got, want) -> float:
    """|got - want| / want of sigma_x, which must be within
    SHARDMAP["sx_rtol"]."""
    rel = abs(float(got) - float(want)) / float(want)
    if not rel <= SHARDMAP["sx_rtol"]:
        raise AssertionError(f"{tag}: sigma_x {float(got)} vs "
                             f"{float(want)} ({rel:.3g})")
    return rel


def master_replay(tag: str, sampler, gs, Z_got, gs_got: dict) -> dict:
    """The master's draws replayed in this process on the ranks' own
    first iteration: the statistics of their gathered Z (after the tail's
    promotion and the deaths) with phase 5's keys give the ranks' A (within
    A_rtol of max |A|) and their active set; gaussian_sse of that Z
    against the ranks' A gives their sigma_x (within sx_rtol) and p′.
    Independent of the sweeps, so it holds A and sigma_x also where a
    boundary event made Z differ from the vmap layout's."""
    import numpy as np
    import torch

    from repro_torch.core.ibp import hybrid as thy

    Xs = sampler.Xs
    P, N_p, D = Xs.shape
    Z = torch.from_numpy(Z_got).to(Xs.device, torch.float32)
    active = torch.from_numpy(gs_got["active"]).to(Xs.device)
    A, _, act, _ = thy.master_step1(thy.local_stats(Xs, Z), active, gs,
                                    sampler.N, D)
    if not torch.equal(act, active):
        raise AssertionError(f"{tag} replay: active {act.tolist()} vs the "
                             f"ranks' {active.tolist()}")
    dA, rel = rel_A(f"{tag} replay", gs_got["A"], A.cpu().numpy())
    A_got = torch.from_numpy(gs_got["A"]).to(Xs.device)
    sx, _, _, pp = thy.master_step2(
        thy.local_sse(Xs, Z, A_got, active), A_got, active, gs,
        sampler.hyp, sampler.N, D, P)
    rel_sx = rel_sigma_x(f"{tag} replay", gs_got["sigma_x"], sx)
    if int(pp) != int(gs_got["p_prime"]):
        raise AssertionError(f"{tag} replay: p' {int(pp)} vs the ranks' "
                             f"{int(gs_got['p_prime'])}")
    return dict(A_max_abs_diff=dA, A_rel_max=rel, sigma_x_rel=rel_sx,
                sigma_x=float(sx), K=int(np.sum(gs_got["active"])))


def compare_first(tag: str, Z_got, gs_got: dict, Z_want, gs_want: dict,
                  sweep: dict) -> dict:
    """One first iteration against another from the same state: Z bits
    (a difference only in shards with a counted boundary event), p′
    equal, and while Z agrees A within SHARDMAP["A_rtol"] of max |A| and
    sigma_x within SHARDMAP["sx_rtol"] (where Z differs,
    ``master_replay`` holds them)."""
    import numpy as np

    diff = Z_got != Z_want
    n_bits = int(diff.sum())
    shards = sorted(set(np.nonzero(diff.any(axis=(1, 2)))[0].tolist()))
    if n_bits and not set(shards) <= set(sweep["shards_with_events"]):
        raise AssertionError(
            f"{tag}: {n_bits} Z bits differ in shards {shards}, where the "
            f"sweep had no boundary event ({sweep})")
    if int(gs_got["p_prime"]) != int(gs_want["p_prime"]):
        raise AssertionError(f"{tag}: p' {gs_got['p_prime']} != "
                             f"{gs_want['p_prime']}")
    out = dict(z_bits_differing=n_bits, shards_differing=shards,
               sigma_x=(float(gs_got["sigma_x"]), float(gs_want["sigma_x"])),
               p_prime=int(gs_got["p_prime"]))
    if not n_bits:
        out["A_max_abs_diff"], out["A_rel_max"] = rel_A(
            tag, gs_got["A"], gs_want["A"])
        out["sigma_x_rel"] = rel_sigma_x(tag, gs_got["sigma_x"],
                                         gs_want["sigma_x"])
    return out


def rank_kernels(sampler, gs, ss, phase: int) -> dict:
    """gibbs_flip, feature_stats and gaussian_sse at a rank's shape: shard
    0's N_p rows of phase 5's final state under ``sampler``'s P, the
    first sweep's inputs on rank 0 (its uniforms included), each against
    its plain version with its times, bound and library call."""
    import torch

    from repro_torch.core.ibp.sweeps import _logit

    Xp, Zp = sampler.Xs[0], ss.Z[0]
    u = shard_uniforms(gs, 0, tuple(Zp.shape), Xp.device)
    tag = f" a rank's N_p rows (phase {phase})"
    return dict(
        gibbs_flip=dict(gibbs_variant(Xp, Zp, gs.A, _logit(gs.pi),
                                      gs.active, u, 0.5 / gs.sigma_x**2,
                                      tag), library_ms=None),
        feature_stats=stats_variant(Xp, Zp, tag),
        gaussian_sse=sse_variant(Xp, Zp, gs.A, gs.active, torch.float32,
                                 tag))


def check_rank_launches(ranks: list, sync: str, L: int) -> None:
    """Each iteration on each rank: gibbs_flip L, collapsed_scan L on its
    chain's p′'s rank (the rank's data coordinate is p′) and 0 elsewhere,
    feature_stats 1, gaussian_sse 1 under staged and 0 under fused; 3
    all-reduces under staged, 1 under fused, none over the chain axis;
    the stale pass: the sweeps and p′'s tail, no collective."""
    from repro_torch import parallel

    for r in ranks:
        run = r[sync]
        for i, st in enumerate(run["steps"]):
            pp = st["p_prime"] == r["shard"]
            want = dict(gibbs_flip=L, collapsed_scan=L if pp else 0,
                        feature_stats=1,
                        gaussian_sse=1 if sync == "staged" else 0)
            want_c = dict(dict.fromkeys(parallel.group.OPS, 0),
                          all_reduce_sum=3 if sync == "staged" else 1)
            got = {k: st["launches"].get(k, 0) for k in want}
            if (got != want or st["collectives"] != want_c
                    or any(st["collectives_chains"].values())):
                raise AssertionError(
                    f"{sync} rank {r['rank']} iteration {i}: launches "
                    f"{got}, collectives {st['collectives']} (over the "
                    f"chain axis {st['collectives_chains']}); expected "
                    f"{want}, {want_c} (none)")
        if "stale" in run:
            st = run["stale"]
            pp = st["p_prime"] == r["shard"]
            want = dict(gibbs_flip=L, collapsed_scan=L if pp else 0,
                        feature_stats=0, gaussian_sse=0)
            got = {k: st["launches"].get(k, 0) for k in want}
            if got != want or any(st["collectives"].values()):
                raise AssertionError(
                    f"stale pass rank {r['rank']}: launches {got}, "
                    f"collectives {st['collectives']}; expected {want}, "
                    f"none")


def check_replicated(ranks: list, sync: str) -> None:
    """Every rank's HybridGlobal equals the first rank's of ``ranks``
    bitwise (one chain's ranks), after the first iteration and after the
    last."""
    import numpy as np

    for r in ranks[1:]:
        for which in ("first", "last"):
            got, want = (
                (x[sync]["first"]["gs"], x[sync]["last"])[which == "last"]
                for x in (r, ranks[0]))
            for f in want:
                if not np.array_equal(got[f], want[f]):
                    raise AssertionError(
                        f"{sync}: rank {r['rank']}'s {f} differs from rank "
                        f"{ranks[0]['rank']}'s after the {which} iteration")


def run_cli_shardmap(tmp: Path, device: str) -> dict:
    """The CLI as SHARDMAP["cli_ranks"] processes of torch.distributed.run
    on ``device`` (the fused sync), on Cambridge data."""
    import os

    sm = SHARDMAP
    out = tmp / "shard_cli.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(sm["cli_ranks"]), "-m",
           "repro_torch.launch.mcmc", "--device", device, "--driver",
           "shardmap", "--sync", "fused", "--P", str(sm["cli_ranks"]),
           "--N", str(sm["cli_N"]), "--K-max", "32", "--iters",
           str(sm["cli_iters"]), "--eval-every", str(sm["cli_iters"] // 2),
           "--ckpt-dir", str(tmp / "shard_cli_ckpt"), "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=600, cwd=str(tmp))
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"shardmap CLI exited {p.returncode}:\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("it=")]
    hist = json.loads(out.read_text())
    its = [r["it"] for r in hist]
    if len(lines) != 2 or its != [sm["cli_iters"] // 2, sm["cli_iters"]]:
        raise AssertionError(f"shardmap CLI: lines {lines}, records at {its}")
    for r in hist:
        if not (math.isfinite(r["joint_ll_eval"]) and 1 <= r["K"] <= 32):
            raise AssertionError(f"shardmap CLI record out of range: {r}")
    return dict(seconds=secs, lines=lines)


def shardmap_kw() -> dict:
    f = FULL
    return dict(P=f["P"], K_max=f["K_max"], K_tail=f["K_tail"], L=f["L"],
                data="shardmap")


def shardmap_job(tmp: Path, data: tuple, phase5: tuple) -> tuple:
    """Phase 13's ``rank_iterations`` arguments: phase 5's rows and
    final Z (written under ``tmp``) and state, both syncs, a stale pass,
    one untimed iteration first."""
    import numpy as np

    f = FULL
    _, gs, ss = phase5
    x_path, z_path = tmp / "shard_x.npy", tmp / "shard_z.npy"
    np.save(x_path, np.ascontiguousarray(data[0][:f["N"]]))
    np.save(z_path, ss.Z.cpu().numpy())
    return (str(x_path), str(z_path), state_np(gs), shardmap_kw(),
            ("staged", "fused"), SHARDMAP["iters"], True, True)


def shardmap_one_job(tmp: Path, data: tuple, phase5: tuple) -> tuple:
    """The world of one rank's ``rank_iterations`` arguments: phase 13's
    inputs at P=1 (all rows on the one shard), one staged iteration."""
    import numpy as np

    _, gs, _ = phase5
    return (str(tmp / "shard_x.npy"), str(tmp / "shard_z.npy"),
            dict(state_np(gs), p_prime=np.zeros((), np.int32)),
            dict(shardmap_kw(), P=1), ("staged",), 1, False, False)


def run_shardmap(tmp: Path, data: tuple, phase5: tuple, dev,
                 spawned: dict) -> tuple[dict, dict]:
    """Phase 13 (its ranks' work done by ``spawn_layouts``): phase 5's
    final state on P ranks of cuda:0, which they share (so over gloo),
    against the vmap layout's first iteration from it and the master's
    draws replayed on the ranks' Z; the kernels at a rank's shape
    against their plain versions; the NCCL world of one rank against the
    vmap layout at P=1; the CLI under torch.distributed.run. Returns
    (results, launches of every rank in the driven iterations,
    summed)."""
    import numpy as np

    from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
    from repro_torch.interop import from_reference

    f, sm = FULL, SHARDMAP
    sampler, gs, ss = phase5
    P, L = f["P"], f["L"]
    kw = shardmap_kw()
    gs_np = state_np(gs)
    ranks, t_spawn = spawned["ranks13"], spawned["spawn_seconds"]
    clock = spawned["clock13"]
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"shardmap ranks on one card ran "
                             f"{[r['backend'] for r in ranks]}, not gloo")

    # the vmap layout's first iteration from the same state, this process
    gs_v, ss_v = sampler.step(gs, ss)
    Z_v, g_v = ss_v.Z.bool().cpu().numpy(), state_np(gs_v)
    sweep = sweep_blocks(sampler, gs, ss)
    res = dict(P=P, N=f["N"], D=f["D"], K_max=f["K_max"], L=L,
               iters=sm["iters"], spawn_seconds=t_spawn, spawn_clock=clock,
               sweep=sweep)
    stamp("[13] the vmap layout's first iteration and the sweep blocks")
    firsts = {}
    for sync in ("staged", "fused"):
        check_replicated(ranks, sync)
        check_rank_launches(ranks, sync, L)
        firsts[sync] = (np.stack([r[sync]["first"]["Z"] for r in ranks]),
                        ranks[0][sync]["first"]["gs"])
        steps = [r[sync]["steps"] for r in ranks]
        per_it = [max(s[i]["seconds"] for s in steps)
                  for i in range(sm["iters"])]
        res[sync] = dict(
            iterations=per_it, seconds_per_iteration=sum(per_it) / len(per_it),
            collectives_per_iteration=steps[0][0]["collectives"],
            # a rank's host time in the collectives: waiting for p′'s
            # tail, and for its own kernels (gloo copies a CUDA payload
            # to the host once the kernels that wrote it are done)
            collective_host_seconds_per_iteration=statistics.mean(
                s[i]["collective_seconds"] for s in steps
                for i in range(sm["iters"])),
            launches_per_rank=[r[sync]["steps"][0]["launches"]
                               for r in ranks],
            p_prime=[s["p_prime"] for s in steps[0]],
            vs_vmap=compare_first(f"shardmap {sync} vs vmap",
                                  *firsts[sync], Z_v, g_v, sweep),
            replay=master_replay(f"shardmap {sync}", sampler, gs,
                                 *firsts[sync]),
            K=int(ranks[0][sync]["last"]["active"].sum()),
            sigma_x=float(ranks[0][sync]["last"]["sigma_x"]))
    res["fused_vs_staged"] = compare_first(
        "shardmap fused vs staged", *firsts["fused"], *firsts["staged"],
        sweep)
    fu = ranks[0]["fused"]
    res["sse"] = dict(identity=fu["sse_identity"], kernel=fu["sse_kernel"],
                      rel_gap=abs(fu["sse_identity"] - fu["sse_kernel"])
                      / fu["sse_kernel"])
    if not res["sse"]["rel_gap"] <= sm["sse_rtol"]:
        raise AssertionError(f"shardmap: the SSE identity is "
                             f"{res['sse']['rel_gap']:.3g} off gaussian_sse "
                             f"(limit {sm['sse_rtol']})")
    stamp("[13] the ranks' holds")
    res["kernels"] = rank_kernels(sampler, gs, ss, 13)
    stamp("[13] the kernels at a rank's shape")
    res["all_reduce_ms"] = {  # the slowest rank's median
        str(n): max(r["all_reduce_ms"][n] for r in ranks)
        for n in ranks[0]["all_reduce_ms"]}
    res["stale"] = dict(
        seconds=max(r["fused"]["stale"]["seconds"] for r in ranks),
        collectives=ranks[0]["fused"]["stale"]["collectives"],
        p_prime=ranks[0]["fused"]["stale"]["p_prime"])
    counts = launches_of(ranks, ("staged", "fused"))

    # one iteration in an NCCL world of one rank against the vmap layout
    # at P=1, from phase 5's state with all rows on the one shard
    kw1 = dict(kw, P=1)
    gs1_np = dict(gs_np, p_prime=np.zeros((), np.int32))
    one, t_one = spawned["one13"], spawned["one_spawn_seconds"]
    s1 = build_sampler(SamplerSpec(**dict(kw1, data="vmap")), IBPHypers(),
                       data[0][:f["N"]], device=dev)
    z1 = ss.Z.cpu().numpy().reshape(1, f["N"], -1)
    g1, st1 = from_reference(gs1_np, dict(
        Z=z1, Z_tail=np.zeros((1, f["N"], f["K_tail"]), np.float32),
        tail_active=np.zeros((1, f["K_tail"]), np.float32)), device=dev)
    g1, st1 = s1.step(g1, st1)
    got, want = one["staged"]["first"], state_np(g1)
    equal = bool(np.array_equal(got["Z"], st1.Z[0].bool().cpu().numpy())
                 and all(np.array_equal(got["gs"][k], want[k])
                         for k in want))
    if one["backend"] != "nccl" or not equal:
        raise AssertionError(f"NCCL world of one ({one['backend']}): not "
                             f"bitwise equal to the vmap layout at P=1")
    res["nccl_one"] = dict(backend=one["backend"], bitwise_equal=equal,
                           seconds=one["staged"]["steps"][0]["seconds"],
                           spawn_seconds=t_one)
    stamp("[13] the NCCL world of one rank")
    res["cli"] = run_cli_shardmap(tmp, "cuda:0")
    return res, counts


# --------------------------------------------------------------------------
# phase 14: the chains x data mesh on C·P ranks
# --------------------------------------------------------------------------


def mesh_state(gs, C: int) -> dict:
    """Phase 5's final HybridGlobal as C chains (numpy, chain-batched):
    chain c keyed by fold_in(key, c), with p′ = c."""
    import numpy as np

    from repro_torch import prng

    out = {k: np.stack([v] * C) for k, v in state_np(gs).items()}
    out["key"] = np.stack([prng.fold_in(gs.key, c).numpy()
                           for c in range(C)])
    out["p_prime"] = np.arange(C, dtype=np.int32)
    return out


def canonical_np(Z, C: int, P: int, K_tail: int) -> dict:
    """Phase 5's final Z (N, K) as every chain's canonical HybridShard at
    P shards, tails empty (numpy)."""
    import numpy as np

    Zc = np.asarray(Z).reshape(P, -1, Z.shape[-1])
    N_p = Zc.shape[1]
    return dict(Z=np.stack([Zc] * C),
                Z_tail=np.zeros((C, P, N_p, K_tail), np.float32),
                tail_active=np.zeros((C, P, K_tail), np.float32))


def mps_state() -> dict:
    """Whether an MPS daemon serves the card: its control pipe (in
    CUDA_MPS_PIPE_DIRECTORY, else the default directory), and the card's
    compute mode. Without MPS the ranks' kernels are time-sliced."""
    import os

    q = subprocess.run(["nvidia-smi", "-i", "0", "-q", "-d", "COMPUTE"],
                       capture_output=True, text=True, timeout=60).stdout
    mode = next((ln.split(":", 1)[1].strip() for ln in q.splitlines()
                 if "Compute Mode" in ln), None)
    pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY")
    control = Path(pipe or "/tmp/nvidia-mps") / "control"
    return dict(active=control.exists(), control_pipe=str(control),
                pipe_directory_env=pipe, compute_mode=mode)


def drive_mesh(x_path: str, xe_path: str, cfg_kw: dict) -> dict:
    """``MCMCDriver`` under driver="mesh" on this rank (``parallel.spawn``):
    its canonical final state, its eval records, its kernel launches and
    its collectives, in all and over the chain axis."""
    import numpy as np

    from repro_torch import parallel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import DriverConfig, MCMCDriver

    drv = MCMCDriver(np.load(x_path), DriverConfig(driver="mesh", **cfg_kw),
                     X_eval=np.load(xe_path))
    reset_launch_counts()
    parallel.reset_collective_counts()
    gs, ss = drv.run()
    return dict(backend=parallel.world().backend, gs=state_np(gs),
                Z=ss.Z.cpu().numpy(), history=drv.history,
                launches=launch_counts(),
                collectives=parallel.collective_counts(),
                collectives_chains=parallel.collective_counts("chains"))


def mesh_one_cfg() -> dict:
    f, m = FULL, MESH
    return dict(K_max=f["K_max"], K_tail=f["K_tail"], L=f["L"], n_chains=1,
                P=1, n_iters=m["one_iters"], eval_every=1,
                ckpt_every=m["one_iters"])


def mesh_one_job(tmp: Path, data: tuple) -> tuple:
    """``drive_mesh``'s arguments for the NCCL world of one rank: phase
    5's first one_rows rows and its held-out rows (written under
    ``tmp``), mesh_one_cfg with a checkpoint directory."""
    import numpy as np

    x_path, xe_path = tmp / "mesh_one_x.npy", tmp / "mesh_one_eval.npy"
    np.save(x_path, np.ascontiguousarray(data[0][:MESH["one_rows"]]))
    np.save(xe_path, np.ascontiguousarray(data[1]))
    return (str(x_path), str(xe_path),
            dict(mesh_one_cfg(), ckpt_dir=str(tmp / "mesh_one_ckpt")))


def run_mesh_one(tmp: Path, data: tuple, dev, got: dict, t_spawn: float
                 ) -> tuple[dict, dict]:
    """driver="mesh" with one chain and one shard in an NCCL world of one
    rank on cuda:0 (gather_global and over_chains send their host
    payloads through the card), with an eval each iteration and a
    checkpoint (``got``: ``drive_mesh``'s result on that rank), against
    the multichain driver at C=1, P=1 in this process on the same rows:
    the final state, the eval records (their clocks aside) and the
    checkpoint files bitwise. Returns (results, the rank's launches)."""
    import numpy as np

    from repro_torch.runtime import DriverConfig, MCMCDriver

    m = MESH
    rows, iters = m["one_rows"], m["one_iters"]
    X = np.ascontiguousarray(data[0][:rows])
    cfg = mesh_one_cfg()
    drv = MCMCDriver(X, DriverConfig(driver="multichain", **dict(
        cfg, ckpt_dir=str(tmp / "multi_one_ckpt"))), X_eval=data[1],
        device=dev)
    gs, ss = drv.run()
    want = state_np(gs)
    fields = [k for k in want if not np.array_equal(got["gs"][k], want[k])]
    z_equal = bool(np.array_equal(got["Z"], ss.Z.cpu().numpy()))
    recs_equal = len({json.dumps([{k: v for k, v in r.items() if k != "t"}
                                  for r in h], sort_keys=True)
                      for h in (got["history"], drv.history)}) == 1
    step = f"step_{iters:09d}.npz"
    a, b = (np.load(tmp / d / step) for d in ("mesh_one_ckpt",
                                              "multi_one_ckpt"))
    ckpt_equal = sorted(a.files) == sorted(b.files) and all(
        np.array_equal(a[k], b[k]) for k in a.files)
    gathers = got["collectives_chains"]["all_gather_rows"]
    if (got["backend"] != "nccl" or fields or not z_equal or not recs_equal
            or not ckpt_equal or gathers < 1):
        raise AssertionError(
            f"mesh driver in an NCCL world of one ({got['backend']}) vs the "
            f"multichain driver at C=1: fields {fields} differ, Z equal "
            f"{z_equal}, eval records equal {recs_equal}, checkpoints "
            f"equal {ckpt_equal}; {gathers} gathers over the chain axis")
    return dict(backend=got["backend"], rows=rows, iters=iters,
                bitwise_equal=True, records=len(got["history"]),
                collectives=got["collectives"],
                collectives_chains=got["collectives_chains"],
                joint_ll_eval=got["history"][-1]["joint_ll_eval"],
                spawn_seconds=t_spawn), got["launches"]


def launches_of(ranks: list, runs: tuple[str, ...]) -> dict:
    """The kernel launches of every rank in the driven iterations and stale
    passes of ``runs``, summed."""
    counts: dict[str, int] = {}
    for r in ranks:
        for run in runs:
            for rec in r[run]["steps"] + [r[run].get("stale", {})]:
                for k, v in rec.get("launches", {}).items():
                    counts[k] = counts.get(k, 0) + v
    return counts


def mesh_job(tmp: Path, data: tuple, phase5: tuple, bank) -> tuple:
    """Phase 14's ``rank_iterations`` arguments: phase 5's rows and final
    Z (written under ``tmp``) as C chains on a C x P mesh, both syncs, a
    stale pass, one untimed iteration first, and the sharded scorer on
    phase 11's ``bank`` (saved under ``tmp``)."""
    import numpy as np

    f, m = FULL, MESH
    _, gs5, ss5 = phase5
    x_path, z_path = tmp / "mesh_x.npy", tmp / "mesh_z.npy"
    bank_path = tmp / "mesh_bank.npz"
    np.save(x_path, np.ascontiguousarray(data[0][:f["N"]]))
    np.save(z_path, ss5.Z.cpu().numpy().reshape(f["N"], -1))
    bank.save(str(bank_path))
    kw = dict(K_max=f["K_max"], K_tail=f["K_tail"], L=f["L"],
              chains="mesh", data="shardmap", n_chains=m["C"], P=m["P"])
    score = dict(bank=str(bank_path),
                 X=np.ascontiguousarray(data[1][:m["score_rows"]]),
                 key=m["score_key"], n_sweeps=SERVING["n_sweeps"],
                 reps=m["score_reps"])
    return (str(x_path), str(z_path), mesh_state(gs5, m["C"]), kw,
            ("staged", "fused"), m["iters"], True, True, score)


def run_mesh(tmp: Path, data: tuple, phase5: tuple, bank, dev,
             spawned: dict) -> tuple[dict, dict]:
    """Phase 14 (its ranks' work done by ``spawn_layouts``): phase 5's
    final state as C chains on a C x P mesh of ranks of cuda:0 (gloo),
    against the multichain layout's first iteration at P and the
    master's draws replayed on each chain's Z; the kernels at a rank's
    shape against their plain versions; the sharded scorer on phase 11's
    bank; chains="mesh" x data="vmap" on C ranks against the multichain
    layout at phase 5's P; the mesh driver in an NCCL world of one rank
    against the multichain driver. Returns (results, launches of every
    rank in the driven iterations and runs, summed)."""
    import numpy as np
    import torch

    from repro_torch import parallel, prng
    from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
    from repro_torch.core.ibp import hybrid as thy
    from repro_torch.core.ibp.predict import predictive_loglik
    from repro_torch.interop import from_reference

    f, m, sm = FULL, MESH, SHARDMAP
    _, gs5, ss5 = phase5
    C, P, L = m["C"], m["P"], f["L"]
    X = data[0][:f["N"]]
    x_path, z_path = tmp / "mesh_x.npy", tmp / "mesh_z.npy"
    Z5 = ss5.Z.cpu().numpy().reshape(f["N"], -1)
    gs_np = mesh_state(gs5, C)
    X_score = np.ascontiguousarray(data[1][:m["score_rows"]])
    widths = dict(K_max=f["K_max"], K_tail=f["K_tail"], L=L)
    ranks, t_spawn = spawned["ranks14"], spawned["spawn_seconds"]
    clock = spawned["clock14"]
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"mesh ranks on one card ran "
                             f"{[r['backend'] for r in ranks]}, not gloo")
    coords = [(r["chain"], r["shard"]) for r in ranks]
    if coords != [divmod(i, P) for i in range(C * P)]:
        raise AssertionError(f"mesh ranks at {coords}, not row-major")
    by_chain = [ranks[c * P:(c + 1) * P] for c in range(C)]

    # the multichain layout's first iteration at P from the same state,
    # and a one-chain sampler at P for the sweep check and the replay
    mc = build_sampler(SamplerSpec(chains="vmap", n_chains=C, P=P, **widths),
                       IBPHypers(), X, device=dev)
    one = build_sampler(SamplerSpec(P=P, **widths), IBPHypers(), X,
                        device=dev)
    gsC, ssC = from_reference(gs_np, canonical_np(Z5, C, P, f["K_tail"]),
                              device=dev)
    g_mc, s_mc = mc.step(gsC, ssC)
    sweeps = [sweep_blocks(one, thy.chain_of(gsC, c), thy.chain_of(ssC, c))
              for c in range(C)]
    res = dict(C=C, P=P, N=f["N"], N_p=f["N"] // P, D=f["D"],
               K_max=f["K_max"], L=L, iters=m["iters"],
               spawn_seconds=t_spawn, spawn_clock=clock, mps=mps_state())
    stamp("[14] the multichain layout's first iteration and the sweeps")
    for sync in ("staged", "fused"):
        check_rank_launches(ranks, sync, L)
        chains = []
        for c, rs in enumerate(by_chain):
            check_replicated(rs, sync)
            Z_got = np.stack([r[sync]["first"]["Z"] for r in rs])
            g_got = rs[0][sync]["first"]["gs"]
            tag = f"mesh {sync} chain {c}"
            steps = rs[0][sync]["steps"]
            chains.append(dict(
                vs_multichain=compare_first(
                    f"{tag} vs multichain", Z_got, g_got,
                    s_mc.Z[c].bool().cpu().numpy(),
                    state_np(thy.chain_of(g_mc, c)), sweeps[c]),
                replay=master_replay(tag, one, thy.chain_of(gsC, c), Z_got,
                                     g_got),
                sweep=sweeps[c],
                p_prime=[st["p_prime"] for st in steps],
                # the device time of the tails of each iteration, on that
                # iteration's p′ rank
                tail_ms=[max(r[sync]["steps"][i]["tail_ms"] for r in rs)
                         for i in range(m["iters"])],
                K=int(rs[0][sync]["last"]["active"].sum()),
                sigma_x=float(rs[0][sync]["last"]["sigma_x"])))
        steps = [r[sync]["steps"] for r in ranks]
        per_it = [max(st[i]["seconds"] for st in steps)
                  for i in range(m["iters"])]
        res[sync] = dict(
            iterations=per_it, seconds_per_iteration=sum(per_it) / len(per_it),
            collectives_per_iteration=steps[0][0]["collectives"],
            collectives_chains_per_iteration=steps[0][0][
                "collectives_chains"],
            collective_host_seconds_per_iteration=statistics.mean(
                st[i]["collective_seconds"] for st in steps
                for i in range(m["iters"])),
            launches_per_rank=[st[0]["launches"] for st in steps],
            chains=chains)
    res["sse"] = []
    for rs in by_chain:
        fu = rs[0]["fused"]
        gap = abs(fu["sse_identity"] - fu["sse_kernel"]) / fu["sse_kernel"]
        if not gap <= sm["sse_rtol"]:
            raise AssertionError(f"mesh: a chain's SSE identity is {gap:.3g}"
                                 f" off gaussian_sse (limit {sm['sse_rtol']})")
        res["sse"].append(gap)
    res["stale"] = dict(
        seconds=max(r["fused"]["stale"]["seconds"] for r in ranks),
        collectives=ranks[0]["fused"]["stale"]["collectives"],
        tail_ms=[max(r["fused"]["stale"]["tail_ms"] for r in rs)
                 for rs in by_chain])
    res["all_reduce_ms"] = {  # the slowest rank's median, a data group
        str(n): max(r["all_reduce_ms"][n] for r in ranks)
        for n in ranks[0]["all_reduce_ms"]}
    counts = launches_of(ranks, ("staged", "fused"))
    # the kernels at a rank's shape against their plain versions: N_p
    # rows of phase 5's final state, and a p′ rank's scan (N_p rows at
    # K_tail, the unchained instance in the tail's default rss flavor)
    # on a planted case, timed alone
    stamp("[14] the chains' holds")
    res["kernels"] = rank_kernels(one, thy.chain_of(gsC, 0),
                                  thy.chain_of(ssC, 0), 14)
    stamp("[14] the kernels at a rank's shape")
    res["scan"] = dict(scan_variant(dev, f["N"] // P, f["K_tail"], f["D"],
                                    700, flavor="fast",
                                    hold_rows=m["scan_hold_rows"]),
                       library_ms=None)
    stamp("[14] the p' rank's scan")
    res["scan"]["shape"] += " fast (a p′ rank's tail, phase 14)"

    # the sharded scorer: each chain's P data ranks score the batch; each
    # rank's result against the blocks scored in this process
    b = m["score_rows"] // P
    key = prng.key(m["score_key"])
    want = torch.cat([predictive_loglik(
        bank, X_score[i * b:(i + 1) * b], prng.fold_in(key, i),
        n_sweeps=SERVING["n_sweeps"]) for i in range(P)]).cpu().numpy()
    diff = max(float(np.abs(r["score"]["scores"] - want).max())
               for r in ranks)
    if not diff <= m["score_tol"]:
        raise AssertionError(f"sharded scorer: {diff} from the one-process "
                             f"blocks (limit {m['score_tol']})")
    Xs_dev = torch.as_tensor(X_score, device=dev)
    t_one = time_ms(lambda: predictive_loglik(
        bank, Xs_dev, key, n_sweeps=SERVING["n_sweeps"]),
        reps=m["score_reps"]) / 1e3
    t_sharded = max(r["score"]["seconds"] for r in ranks)
    res["scorer"] = dict(
        rows=m["score_rows"], S=bank.S, K_bucket=bank.K, ranks=P,
        groups=C, max_abs_diff=diff, seconds=t_sharded,
        rows_per_s=m["score_rows"] / t_sharded,
        one_process_seconds=t_one,
        one_process_rows_per_s=m["score_rows"] / t_one)

    # chains="mesh" x data="vmap": a chain a rank, phase 5's P shards
    # simulated on it, against the multichain layout at phase 5's P
    kwv = dict(widths, chains="mesh", data="vmap", n_chains=C, P=f["P"])
    stamp("[14] the sharded scorer")
    t0, w0 = time.perf_counter(), time.time()
    ranks_v = parallel.spawn(rank_iterations, C, str(x_path), str(z_path),
                             gs_np, kwv, ("staged",), m["vmap_iters"], False,
                             True, None, device="cuda:0", timeout_s=600)
    t_spawn_v = time.perf_counter() - t0
    spawn_clock(ranks_v, w0, "[14] mesh x vmap")
    mc8 = build_sampler(SamplerSpec(chains="vmap", n_chains=C, P=f["P"],
                                    **widths), IBPHypers(), X, device=dev)
    g8, s8 = mc8.step(*from_reference(
        gs_np, canonical_np(Z5, C, f["P"], f["K_tail"]), device=dev))
    vm = dict(chains=[])
    for c, r in enumerate(ranks_v):
        for i, st in enumerate(r["staged"]["steps"]):
            want_l = dict(gibbs_flip=L, collapsed_scan=L, feature_stats=1,
                          gaussian_sse=1)
            got_l = {k: st["launches"].get(k, 0) for k in want_l}
            if got_l != want_l or any(st["collectives"].values()):
                raise AssertionError(
                    f"mesh x vmap rank {c} iteration {i}: launches {got_l},"
                    f" collectives {st['collectives']}; expected {want_l}, "
                    f"none")
        got, want_g = r["staged"]["first"], state_np(thy.chain_of(g8, c))
        n_bits = int((got["Z"] != s8.Z[c].reshape(f["N"], -1).bool()
                      .cpu().numpy()).sum())
        ints = [k for k in ("key", "p_prime", "it", "active", "overflow",
                            "tail_sat")
                if not np.array_equal(got["gs"][k], want_g[k])]
        if n_bits or ints:
            raise AssertionError(f"mesh x vmap chain {c} vs multichain: "
                                 f"{n_bits} Z bits, fields {ints} differ")
        dA, rel = rel_A(f"mesh x vmap chain {c}", got["gs"]["A"],
                        want_g["A"])
        vm["chains"].append(dict(
            z_bits_differing=n_bits, A_max_abs_diff=dA, A_rel_max=rel,
            sigma_x_rel=rel_sigma_x(f"mesh x vmap chain {c}",
                                    got["gs"]["sigma_x"],
                                    want_g["sigma_x"]),
            bitwise_equal=all(np.array_equal(got["gs"][k], want_g[k])
                              for k in want_g),
            tail_ms=[st["tail_ms"] for st in r["staged"]["steps"]]))
    per_it = [max(r["staged"]["steps"][i]["seconds"] for r in ranks_v)
              for i in range(m["vmap_iters"])]
    vm.update(P=f["P"], iters=m["vmap_iters"], iterations=per_it,
              seconds_per_iteration=sum(per_it) / len(per_it),
              spawn_seconds=t_spawn_v)
    res["mesh_vmap"] = vm
    stamp("[14] chains=mesh x data=vmap")
    res["nccl_one"], one_counts = run_mesh_one(
        tmp, data, dev, spawned["one14"], spawned["one_spawn_seconds"])
    for c in (launches_of(ranks_v, ("staged",)), one_counts):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return res, counts


# --------------------------------------------------------------------------
# phase 15: the LM substrate on the card
# --------------------------------------------------------------------------


def decode_logits(model, cfg, toks, dev, extra: dict | None = None
                  ) -> tuple:
    """Teacher-forced decode of ``toks`` (B, S) one step a token (``extra``
    in every step's batch): the logits (B, S, Vp) and the caches."""
    import torch
    from repro_torch.models import init_caches, model_apply

    B, S = toks.shape
    caches, out = init_caches(cfg, B, S, dev), []
    with torch.no_grad():
        for i in range(S):
            lg, _, caches = model_apply(
                model, {"tokens": toks[:, i:i + 1], **(extra or {})}, cfg,
                mode="decode", caches=caches)
            out.append(lg[:, 0])
    return torch.stack(out, 1), caches


def logits_gap(got, want) -> dict:
    """max |got - want| against rel_tol of max |want|, and the argmaxes
    that differ where want's top two are more than tie_gap apart."""
    import torch

    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < LM["tie_gap"]
    differ = got.argmax(-1) != want.argmax(-1)
    scale = float(want.abs().max())
    return dict(positions=int(near.numel()),
                max_abs_err=float((got - want).abs().max()),
                max_abs_logit=scale, limit=LM["rel_tol"] * scale,
                near_ties=int(near.sum()), argmax_differing=int(differ.sum()),
                argmax_differing_outside_ties=int((differ & ~near).sum()),
                finite=bool(torch.isfinite(got).all()
                            and torch.isfinite(want).all()))


def held(r: dict, what: str, phase: int = 16, logits: bool = True) -> dict:
    """Raise unless the argmaxes agree outside near ties and (``logits``)
    the logits are within their limit."""
    if not r["finite"] or r["argmax_differing_outside_ties"] or \
            (logits and r["max_abs_err"] > r["limit"]):
        raise AssertionError(f"phase {phase}: {what}: {r}")
    return r


def lm_decode_hold(model, cfg, dev, phase: int = 15) -> dict:
    """The reference's test_decode_matches_prefill_logits at full size:
    hold_B sequences of hold_steps tokens teacher-forced through the
    decode step, each step's logits against the "train" forward's at
    that position (within rel_tol of max |logit|), the argmaxes equal
    except where the forward's top two logits are within tie_gap. encdec
    feeds enc_out zeros to both, as the serving CLI does: with another
    enc_out the decode step ropes the cross-attention query at position 0
    (the reference's behaviour, ROADMAP §3), so that gap is reported and
    not held."""
    import numpy as np
    import torch
    from repro_torch.models import model_apply

    B, S = LM["hold_B"], LM["hold_steps"]
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)

    def both(extra: dict) -> tuple:
        with torch.no_grad():
            fwd = model_apply(model, {"tokens": toks, **extra}, cfg,
                              mode="train")[0]
        return (fwd, *decode_logits(model, cfg, toks, dev, extra))

    extra = {}
    if cfg.family == "encdec":
        extra["enc_out"] = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                       device=dev)
    fwd, dec, caches = both(extra)
    r = dict(**logits_gap(dec, fwd), cache_length=int(caches[0].length))
    held(r, f"{cfg.name} decode against the forward", phase)
    if r["cache_length"] != S:
        raise AssertionError(f"phase {phase}: {cfg.name} cache length: {r}")
    if cfg.family == "encdec":
        enc = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32)).to(dev)
        f2, d2, _ = both({"enc_out": enc})
        r["random_enc_out_gap"] = float((d2 - f2).abs().max())
    return r


def lm_cpu_hold(model, cfg, dev, phase: int = 15, n: int | None = None,
                host=None) -> dict:
    """The first ``n`` (default cpu_layers) layers of ``model`` (the
    encoder's too), on the card against the same weights on the CPU: the
    float32 "train" forward of hold_B x hold_steps tokens (and random
    frames for encdec), within rel_tol of max |logit|; the aux losses
    (MoE) within rel_tol of the CPU's. Where ``n`` covers every layer,
    ``model`` itself runs on the card, and ``host``, if given, is its
    CPU copy."""
    import numpy as np
    import torch
    from repro_torch.models import model_apply, transformer

    n = n or LM["cpu_layers"]
    small_cfg = dataclasses.replace(
        cfg, n_layers=min(n, cfg.n_layers),
        n_enc_layers=min(n, cfg.n_enc_layers))
    whole = (small_cfg.n_layers, small_cfg.n_enc_layers) == \
        (cfg.n_layers, cfg.n_enc_layers)
    sd = model.state_dict()
    card = model if whole else transformer.LM(small_cfg, dev)
    if host is None or not whole:
        host = transformer.LM(small_cfg, "cpu")
        host.load_state_dict({k: sd[k] for k in host.state_dict()})
    if card is not model:
        card.load_state_dict({k: sd[k] for k in card.state_dict()})
    B, S = LM["hold_B"], LM["hold_steps"]
    rng = np.random.default_rng(16)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32))
    with torch.no_grad():
        got, got_aux, _ = model_apply(
            card, {k: v.to(dev) for k, v in batch.items()}, small_cfg,
            mode="train")
        want, want_aux, _ = model_apply(host, batch, small_cfg, mode="train")
    got = got.cpu()
    scale = float(want.abs().max())
    r = dict(layers=small_cfg.n_layers, enc_layers=small_cfg.n_enc_layers,
             max_abs_err=float((got - want).abs().max()),
             max_abs_logit=scale, limit=LM["rel_tol"] * scale,
             aux=float(got_aux), aux_cpu=float(want_aux))
    if not torch.isfinite(got).all() or r["max_abs_err"] > r["limit"] or \
            abs(r["aux"] - r["aux_cpu"]) > LM["rel_tol"] * abs(r["aux_cpu"]):
        raise AssertionError(f"phase {phase}: {cfg.name} card against CPU: "
                             f"{r}")
    return r


def lm_serve(cfg, dev, new: int, model=None) -> dict:
    """serve.generate at the CLI's batch and prompt length: tokens/s with
    the prompt's teacher-forced steps, the loop's wall time (ended by a
    device synchronise), the peak device memory (and what earlier phases
    still held when it was reset), and the generated ids at or past the
    real vocab (the padded-vocab argmax, ROADMAP §3)."""
    import torch
    from repro_torch.launch import serve

    B, S = LM["serve_B"], LM["serve_prompt"]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    r = serve.generate(cfg, batch=B, prompt_len=S, new=new, device=dev,
                       model=model)
    seq, dt = r["seq"], r["seconds"]
    out = dict(model=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               batch=B, prompt_len=S, new=new, seconds=dt,
               tokens_per_s=B * (S + new) / dt, new_tokens_per_s=B * new / dt,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               memory_held_before=held,
               ids_past_vocab=int((seq[:, S:] >= cfg.vocab).sum()),
               sample=seq[0, -new:].tolist())
    if seq.shape != (B, S + new) or int(seq.min()) < 0:
        raise AssertionError(f"phase 15: {cfg.name} serve: {out}")
    return out


def lm_step_profile(cfg, dev, steps: int = 8, model=None) -> dict:
    """Where a bf16 decode step's time goes at the serving CLI's widths:
    ``steps`` steps after the prompt's 32 (host clock around each, ended
    by a synchronise) and the same steps under torch.profiler: device
    kernels a step and their summed device time, so the device's busy
    share of a step. ``model``: float32 weights to cast (default: drawn
    from seed 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import init_caches, init_model, make_decode_step
    from repro_torch.models.lm import cast_params

    B, S = LM["serve_B"], LM["serve_prompt"]
    if model is None:
        model = init_model(0, cfg, device=dev)
    model = cast_params(model, cfg)
    step = make_decode_step(cfg)
    caches = init_caches(cfg, B, S + 2 * steps, dev)
    tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    # the encoder's output as the serving CLI feeds it: zeros
    extras = {"enc_out": torch.zeros((B, cfg.enc_seq, cfg.d_model),
                                     device=dev)} \
        if cfg.family == "encdec" else {}
    for _ in range(S):
        tok, caches = step(model, {"tokens": tok, **extras}, caches)
        tok = tok[:, None]
    torch.cuda.synchronize(dev)
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        tok, caches = step(model, {"tokens": tok, **extras}, caches)
        tok = tok[:, None]
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok, caches = step(model, {"tokens": tok, **extras}, caches)
            tok = tok[:, None]
        torch.cuda.synchronize(dev)
    ev = kernel_events(prof)
    dev_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3 / steps
    wall_ms = statistics.median(walls) * 1e3
    return dict(model=cfg.name, dtype=cfg.dtype, batch=B, steps=steps,
                wall_ms_per_step=wall_ms, device_ms_per_step=dev_ms,
                kernels_per_step=len(ev) / steps,
                busy_share=dev_ms / wall_ms if wall_ms else None)


def gelu_step_profiles(cfg, dev, model) -> dict:
    """A bf16 decode step of a gelu model as it runs (``modules.gelu``,
    JAX's roundings op by op) and, in the same process, with
    ``modules.gelu`` swapped for one ``F.gelu(approximate="tanh")`` call
    (one kernel, one rounding): what the exact form costs a step."""
    import torch.nn.functional as F
    from repro_torch.models import modules

    exact = modules.gelu
    out = {"step_profile": lm_step_profile(cfg, dev, model=model)}
    modules.gelu = lambda h: F.gelu(h, approximate="tanh")
    try:
        out["step_profile_fused_gelu"] = lm_step_profile(cfg, dev,
                                                         model=model)
    finally:
        modules.gelu = exact
    return out


def lm_compose(model, cfg, dev) -> tuple[dict, dict]:
    """examples/ibp_over_lm_features.py with the port on the card: the
    full-width backbone's "train" logits of ibp_N windows of ibp_seq
    tokens (SyntheticLM seed ibp_data_seed, step ibp_data_step),
    mean-pooled, standardised and projected to ibp_D by a Gaussian matrix
    from a torch.Generator, then the hybrid sampler for ibp_iters
    iterations; the kernel counts are set to 0 just before the sampler
    runs and read just after."""
    import torch
    from repro_torch import prng
    from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model_apply

    data = SyntheticLM(vocab=cfg.vocab, seq_len=LM["ibp_seq"],
                       global_batch=LM["ibp_N"], seed=LM["ibp_data_seed"])
    tokens = torch.from_numpy(
        data.batch(step=LM["ibp_data_step"])["tokens"]).long().to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        feats = model_apply(model, {"tokens": tokens}, cfg,
                            mode="train")[0].mean(dim=1)
    feats = (feats - feats.mean(0)) / (feats.std(0, unbiased=False) + 1e-6)
    D = min(LM["ibp_D"], feats.shape[1])
    g = torch.Generator(device=dev).manual_seed(LM["ibp_proj_seed"])
    proj = torch.randn((feats.shape[1], D), generator=g, device=dev) \
        / math.sqrt(feats.shape[1])
    X = (feats @ proj).cpu().numpy()
    embed_s = time.perf_counter() - t0
    spec = SamplerSpec(**LM["ibp_spec"])
    sampler = build_sampler(spec, IBPHypers(), X, device=dev)
    gs, ss = sampler.init(prng.key(1))
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(LM["ibp_iters"]):
        gs, ss = sampler.step(gs, ss)
    K = int(gs.active.sum())
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    r = dict(backbone=cfg.name, N=int(X.shape[0]), D=int(X.shape[1]),
             embed_seconds=embed_s, iters=LM["ibp_iters"],
             seconds_per_iteration=seconds / LM["ibp_iters"], K_plus=K,
             alpha=float(gs.alpha), sigma_x=float(gs.sigma_x),
             launches={k: counts.get(k, 0) for k in MAIN_PATH},
             finite=bool(math.isfinite(float(X.sum()))), **LM["ibp_spec"])
    if K < 1 or not r["finite"] or counts.get("gibbs_flip", 0) < 1 or \
            counts.get("collapsed_scan", 0) < 1:
        raise AssertionError(f"phase 15d: IBP over {cfg.name}: {r}")
    return r, counts


def run_lm(dev, smi: str) -> tuple[dict, dict]:
    """Phase 15: (a) smollm-135m's serving CLI at its full width and
    defaults, then the same loop timed; (b) one set of float32 weights
    drawn on the card, decode against the forward and card against CPU;
    (c) the cut models, their holds and a bf16 serve; (d) the
    composition with the hybrid sampler on (b)'s weights."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_model

    out: dict = {"gpu": smi}
    cfg = get_config(LM["arch"])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main([])
    out["cli_seconds"] = time.perf_counter() - t0
    out["cli"] = buf.getvalue().strip().splitlines()
    out["serve"] = lm_serve(cfg, dev, LM["serve_new"])
    out["step_profile"] = lm_step_profile(cfg, dev)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg32,
                       device=dev)
    out["models"] = [dict(model=cfg.name, layers=cfg.n_layers,
                          decode_vs_forward=lm_decode_hold(model, cfg32, dev),
                          card_vs_cpu=lm_cpu_hold(model, cfg32, dev),
                          serve=out["serve"])]
    out["compose"], counts = lm_compose(model, cfg32, dev)
    del model
    for arch in LM["cut"]:
        full = get_config(arch)
        cut = dataclasses.replace(
            full, n_layers=LM["cut_layers"],
            n_enc_layers=LM["cut_layers"] if full.n_enc_layers else 0)
        c32 = dataclasses.replace(cut, dtype="float32")
        m = init_model(torch.Generator(device=dev).manual_seed(0), c32,
                       device=dev)
        out["models"].append(dict(
            model=arch, layers=cut.n_layers, enc_layers=cut.n_enc_layers,
            decode_vs_forward=lm_decode_hold(m, c32, dev),
            card_vs_cpu=lm_cpu_hold(m, c32, dev),
            serve=lm_serve(cut, dev, LM["cut_new"], model=m)))
        if cut.act == "gelu":
            out["models"][-1].update(gelu_step_profiles(cut, dev, m))
        del m
        torch.cuda.empty_cache()
    return out, counts


# --------------------------------------------------------------------------
# phase 16: the LM's other temporal mixers on the card
# --------------------------------------------------------------------------


def ring_hold(model, cfg, dev) -> dict:
    """The hybrid's ring cache wrapped at full width: one superblock (rec,
    rec, local attention), ring_B sequences of local_window + ring_extra
    tokens teacher-forced through decode against the "train" forward."""
    import numpy as np
    import torch
    from repro_torch.models import model_apply, transformer

    small = dataclasses.replace(cfg, n_layers=len(cfg.rglru_pattern))
    card = transformer.LM(small, dev)
    sd = model.state_dict()
    card.load_state_dict({k: sd[k] for k in card.state_dict()})
    B, S = MIXERS["ring_B"], cfg.local_window + MIXERS["ring_extra"]
    rng = np.random.default_rng(17)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        fwd = model_apply(card, {"tokens": toks}, small, mode="train")[0]
    dec, caches = decode_logits(card, small, toks, dev)
    ring = caches[2].k.shape[1]
    r = dict(layers=small.n_layers, batch=B, steps=S, ring_slots=ring,
             wraps=S // ring, seconds=time.perf_counter() - t0,
             **logits_gap(dec, fwd))
    if ring != cfg.local_window or S <= ring:
        raise AssertionError(f"phase 16: the ring did not wrap: {r}")
    return held(r, f"{cfg.name} ring decode against the forward")


def run_recurrent(arch: str, dev, smi: str) -> dict:
    """16a / 16b: the CLI at full width and depth, then one set of float32
    weights drawn on the card: phase 15's holds (card against CPU at one
    superblock for the hybrid), the hybrid's ring, the timed serve and a
    profiled bf16 step cast from those weights."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_model

    cfg = get_config(arch)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", arch])
    out = dict(model=arch, layers=cfg.n_layers, gpu=smi,
               cli_seconds=time.perf_counter() - t0,
               cli=buf.getvalue().strip().splitlines())
    stamp(f"[16] {arch}: the serving CLI")
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m = init_model(torch.Generator(device=dev).manual_seed(0), cfg32,
                   device=dev)
    stamp(f"[16] {arch}: float32 weights drawn")
    out["decode_vs_forward"] = lm_decode_hold(m, cfg32, dev, phase=16)
    stamp(f"[16] {arch}: decode against the forward")
    n = len(cfg.rglru_pattern) if cfg.family == "hybrid" else None
    out["card_vs_cpu"] = lm_cpu_hold(m, cfg32, dev, phase=16, n=n)
    stamp(f"[16] {arch}: card against CPU")
    if cfg.family == "hybrid":
        out["ring"] = ring_hold(m, cfg32, dev)
        stamp(f"[16] {arch}: the ring")
    out["serve"] = lm_serve(cfg, dev, LM["serve_new"], model=m)
    out["step_profile"] = lm_step_profile(
        cfg, dev, steps=MIXERS["profile_steps"], model=m)
    stamp(f"[16] {arch}: the timed serve and the profiled step")
    del m
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recording_drops(log: list):
    """Record, for each MoE layer's dispatch while inside, the routed
    slots that its capacity dropped (a host read each; for reporting)."""
    from repro_torch.models import moe

    orig = moe._dispatch

    def recorded(expert_ids, gate_vals, counts, E, C, T):
        out = orig(expert_ids, gate_vals, counts, E, C, T)
        log.append(expert_ids.numel() - int((out[0] != T).sum()))
        return out

    moe._dispatch = recorded
    try:
        yield
    finally:
        moe._dispatch = orig


def run_moe(arch: str, dev, smi: str) -> dict:
    """16c: an MoE model at full width cut to its moe_layers, float32
    weights drawn on the card: card against CPU (forward logits and aux);
    hold_B x cpu_decode_steps decode steps on the card against the same
    on the CPU (greedy tokens equal outside near ties); decode against the
    forward at capacity_factor = n_experts / top_k, where no slot drops
    (held), and at the config's capacity (reported: decode's T = B gives
    C = 1); a bf16 serve of cut_new tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, model_apply, transformer

    full = get_config(arch)
    cut = dataclasses.replace(full, n_layers=MIXERS["moe_layers"][arch])
    c32 = dataclasses.replace(cut, dtype="float32")
    no_drop = dataclasses.replace(
        c32, capacity_factor=full.n_experts / full.top_k)
    B, S = LM["hold_B"], LM["hold_steps"]
    for T in (B, B * S):
        if int(T * full.top_k / full.n_experts
               * no_drop.capacity_factor) < T:
            raise AssertionError(f"phase 16: {arch}: capacity under T={T}")
    m = init_model(torch.Generator(device=dev).manual_seed(0), c32,
                   device=dev)
    out = dict(model=arch, layers=cut.n_layers, gpu=smi,
               params=sum(p.numel() for p in m.parameters()))
    # one CPU copy for both holds (deepseek-v2's is 20 GB)
    host = transformer.LM(c32, "cpu")
    host.load_state_dict(m.state_dict())
    stamp(f"[16] {arch}: float32 weights drawn and copied to the CPU")
    out["card_vs_cpu"] = lm_cpu_hold(m, c32, dev, phase=16, host=host)
    stamp(f"[16] {arch}: card against CPU")

    rng = np.random.default_rng(18)
    toks = torch.from_numpy(rng.integers(0, cut.vocab, (B, S)))
    short = toks[:, :MIXERS["cpu_decode_steps"]]
    t0 = time.perf_counter()
    dec_cpu, _ = decode_logits(host, c32, short, "cpu")
    cpu_s = time.perf_counter() - t0
    del host
    toks = toks.to(dev)
    dec, _ = decode_logits(m, c32, short.to(dev), dev)
    out["decode_card_vs_cpu"] = held(
        dict(**logits_gap(dec.cpu(), dec_cpu), cpu_seconds=cpu_s),
        f"{arch} decode on the card against the CPU", logits=False)
    stamp(f"[16] {arch}: decode card against CPU")

    with torch.no_grad():
        fwd = model_apply(m, {"tokens": toks}, no_drop, mode="train")[0]
    dec_nd, _ = decode_logits(m, no_drop, toks, dev)
    out["decode_vs_forward_no_drop"] = held(
        dict(**logits_gap(dec_nd, fwd), capacity_factor=
             no_drop.capacity_factor),
        f"{arch} decode against the forward at no drop")

    fwd_drops, dec_drops = [], []
    with recording_drops(fwd_drops), torch.no_grad():
        fwd = model_apply(m, {"tokens": toks}, c32, mode="train")[0]
    with recording_drops(dec_drops):
        dec, _ = decode_logits(m, c32, toks, dev)
    L, k = cut.n_layers, cut.top_k
    out["decode_vs_forward_config"] = dict(
        **logits_gap(dec, fwd), capacity_factor=c32.capacity_factor,
        forward_slots_dropped=sum(fwd_drops), forward_slots=L * B * S * k,
        decode_slots_dropped_per_step=sum(dec_drops) / S,
        decode_slots_per_step=L * B * k)
    stamp(f"[16] {arch}: decode against the forward")
    out["serve"] = lm_serve(cut, dev, LM["cut_new"], model=m)
    del m
    torch.cuda.empty_cache()
    return out


def run_lm_mixers(dev, smi: str) -> dict:
    """Phase 16: 16a falcon-mamba-7b and 16b recurrentgemma-2b at full
    width and depth; 16c the MoE models cut in depth."""
    return dict(ssm=run_recurrent(MIXERS["ssm"], dev, smi),
                hybrid=run_recurrent(MIXERS["hybrid"], dev, smi),
                moe=[run_moe(a, dev, smi) for a in MIXERS["moe_layers"]])


def log_lm_mixers(mixers: dict, smi: str) -> None:
    """Phase 16's lines: one JSON line a model, then its summary."""
    for v in (mixers["ssm"], mixers["hybrid"], *mixers["moe"]):
        log(f"[16] {json.dumps(v)}")
    for v in (mixers["ssm"], mixers["hybrid"]):
        for line in v["cli"]:
            log(f"[16] CLI (repro_torch.launch.serve --arch {v['model']}): "
                f"{line}")
        sv, sp = v["serve"], v["step_profile"]
        h, c = v["decode_vs_forward"], v["card_vs_cpu"]
        log(f"[16] serve {v['model']} ({sv['layers']} layers, {sv['dtype']}),"
            f" B={sv['batch']}, prompt {sv['prompt_len']}, {sv['new']} new: "
            f"{sv['tokens_per_s']:.1f} tok/s inc. prefill "
            f"({sv['new_tokens_per_s']:.1f} new tok/s), wall "
            f"{sv['seconds']:.4f} s, peak device memory "
            f"{sv['max_memory_allocated']} bytes ({sv['memory_held_before']} "
            f"held before the loop: the float32 weights); the CLI's run took "
            f"{v['cli_seconds']:.2f} s; one bf16 decode step (median of "
            f"{sp['steps']}): wall {sp['wall_ms_per_step']:.3f} ms, "
            f"{sp['kernels_per_step']:.0f} device kernels taking "
            f"{sp['device_ms_per_step']:.3f} ms, device busy "
            f"{sp['busy_share']:.3f}; gpu: {smi}")
        log(f"[16] {v['model']} float32: decode vs forward over "
            f"{h['positions']} positions max |diff| {h['max_abs_err']:.3g} "
            f"(limit {h['limit']:.3g}), {h['argmax_differing']} argmaxes "
            f"differ, {h['near_ties']} near ties; card vs CPU at "
            f"{c['layers']} layers max |diff| {c['max_abs_err']:.3g} (limit "
            f"{c['limit']:.3g})")
        if "ring" in v:
            r = v["ring"]
            log(f"[16] {v['model']} ring: {r['layers']} layers, B={r['batch']},"
                f" {r['steps']} decode steps through {r['ring_slots']} slots "
                f"({r['wraps']} wrap) against the forward: max |diff| "
                f"{r['max_abs_err']:.3g} (limit {r['limit']:.3g}), "
                f"{r['argmax_differing']} argmaxes differ, {r['near_ties']} "
                f"near ties; {r['seconds']:.1f} s")
    for v in mixers["moe"]:
        c, dc = v["card_vs_cpu"], v["decode_card_vs_cpu"]
        nd, cf = v["decode_vs_forward_no_drop"], v["decode_vs_forward_config"]
        sv = v["serve"]
        log(f"[16] {v['model']} at {v['layers']} layers ({v['params']} "
            f"parameters): card vs CPU forward max |diff| "
            f"{c['max_abs_err']:.3g} (limit {c['limit']:.3g}), aux "
            f"{c['aux']:.6g} vs {c['aux_cpu']:.6g}; decode card vs CPU "
            f"{dc['argmax_differing']} tokens differ ({dc['near_ties']} near "
            f"ties), max |diff| {dc['max_abs_err']:.3g}, the CPU's "
            f"{dc['cpu_seconds']:.1f} s; decode vs forward at capacity "
            f"factor {nd['capacity_factor']:.4g} (no drop) max |diff| "
            f"{nd['max_abs_err']:.3g} (limit {nd['limit']:.3g}), at "
            f"{cf['capacity_factor']}: max |diff| {cf['max_abs_err']:.3g}, "
            f"{cf['argmax_differing']} argmaxes differ, slots dropped "
            f"{cf['decode_slots_dropped_per_step']:.2f} of "
            f"{cf['decode_slots_per_step']} a decode step, "
            f"{cf['forward_slots_dropped']} of {cf['forward_slots']} in the "
            f"forward; bf16 serve {sv['tokens_per_s']:.1f} tok/s inc. "
            f"prefill, peak {sv['max_memory_allocated']} bytes; gpu: {smi}")

# --------------------------------------------------------------------------
# phase 17: LM training on the card
# --------------------------------------------------------------------------

STEP_LINE = r"step\s+(\d+) loss=(\S+) \(([\d,.]+) tok/s\)"


def train_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """B sequences of S tokens (and random frames for encdec) from a
    numpy seed, on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                          dtype=np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def parse_train_log(out: str) -> tuple[dict, list]:
    """The training CLI's stdout: {step: (loss, tok/s)} and its other
    lines."""
    import re

    steps = {int(m[1]): (float(m[2]), float(m[3].replace(",", "")))
             for m in re.finditer(STEP_LINE, out)}
    return steps, [ln for ln in out.splitlines()
                   if not re.match(STEP_LINE, ln)]


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timing_train_steps(record: dict):
    """While inside, every step that ``launch.train``'s make_train_step
    builds records its host wall, ended by a device synchronise, in
    record["walls"], and its last (step, model, state, batch) in
    record["last"]."""
    from repro_torch.launch import train

    orig = train.make_train_step

    def timed_factory(cfg, optimizer):
        step = orig(cfg, optimizer)

        def timed(model, state, batch):
            t0 = time.perf_counter()
            out = step(model, state, batch)
            sync(next(model.parameters()).device)
            record.setdefault("walls", []).append(time.perf_counter() - t0)
            record["last"] = (step, out[0], out[1], batch)
            return out

        return timed

    train.make_train_step = timed_factory
    try:
        yield record
    finally:
        train.make_train_step = orig


def run_train_cli(tmp: Path, dev) -> dict:
    """17a: the training CLI (``launch.train.main``) at the arch's full
    width and depth and its defaults (bf16, remat, B=8, S=256) for
    cli_steps steps with a checkpoint every ckpt_every, in this process:
    each step's host wall ended by a device synchronise (the median over
    steps time_from..cli_steps), the peak device memory, then one more
    step under torch.profiler (kernels, device time, busy share). Then
    ``python -m repro_torch.launch.train`` in a second process resumed
    from a copy of the step-resume_from checkpoint alone: its losses
    within resume_rtol of the first run's at the same steps."""
    import io
    import os
    import shutil

    import torch
    from repro_torch.launch import train

    argv = ["--arch", TRAIN["arch"], "--steps", str(TRAIN["cli_steps"]),
            "--ckpt-every", str(TRAIN["ckpt_every"]), "--log-every", "1",
            "--device", str(dev)]
    n, at = TRAIN["cli_steps"], TRAIN["resume_from"]
    cuda = torch.device(dev).type == "cuda"
    sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if cuda else 0
    buf, record = io.StringIO(), {}
    t0 = time.perf_counter()
    with timing_train_steps(record), contextlib.redirect_stdout(buf):
        train.main(argv + ["--ckpt-dir", str(tmp / "train17")])
    seconds = time.perf_counter() - t0
    stamp("[17] the training CLI in this process")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    steps, lines = parse_train_log(buf.getvalue())
    if sorted(steps) != list(range(1, n + 1)) or len(record["walls"]) != n:
        raise AssertionError(f"phase 17: the CLI logged steps "
                             f"{sorted(steps)}")
    step, model, state, batch = record.pop("last")
    prof = profile_call(lambda: step(model, state, batch)) if cuda else {}
    del step, model, state, batch
    stamp("[17] one train step profiled")

    name = f"step_{at:09d}.npz"
    (tmp / "train17_resume").mkdir()
    shutil.copy(tmp / "train17" / name, tmp / "train17_resume" / name)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *argv, "--ckpt-dir", str(tmp / "train17_resume")],
                       capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"phase 17: the resumed CLI: rc "
                             f"{r.returncode}\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-3000:]}")
    stamp("[17] the resumed CLI")
    resumed, resume_lines = parse_train_log(r.stdout)
    if f"resumed from step {at}" not in resume_lines or \
            sorted(resumed) != list(range(at + 1, n + 1)):
        raise AssertionError(f"phase 17: the resumed CLI: {resume_lines}"
                             f" steps {sorted(resumed)}")
    gaps = [abs(resumed[s][0] - steps[s][0]) / abs(steps[s][0])
            for s in resumed]
    walls = record["walls"][TRAIN["time_from"] - 1:]
    med = statistics.median(walls)
    out = dict(arch=TRAIN["arch"], steps=n, batch=TRAIN["batch"],
               seq=TRAIN["seq"], first_loss=steps[1][0],
               last_loss=steps[n][0], seconds=seconds,
               cli_tokens_per_s=steps[n][1], time_from=TRAIN["time_from"],
               step_ms_median=med * 1e3, step_ms_min=min(walls) * 1e3,
               step_ms_max=max(walls) * 1e3,
               tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / med,
               peak_memory=peak, memory_held_before=held, profile=prof,
               lines=lines, resume_lines=resume_lines,
               resume_seconds=time.perf_counter() - t1, resume_from=at,
               resume_max_rel=max(gaps), resume_limit=TRAIN["resume_rtol"])
    if not all(math.isfinite(v[0]) for v in steps.values()) or \
            out["resume_max_rel"] > TRAIN["resume_rtol"]:
        raise AssertionError(f"phase 17: the resumed losses: {out}")
    return out


def remat_off_steps(cfg, dev) -> dict:
    """remat_off_steps steps of the CLI's loop in this process without
    remat (weights from seed 0, SyntheticLM batches of B=8, S=256): the
    peak device memory, and the median host wall of the steps after the
    first, each ended by a device synchronise."""
    import torch
    from repro_torch.data.synthetic_lm import SyntheticLM
    from repro_torch.interop import reference_leaves
    from repro_torch.models import init_model, make_train_step
    from repro_torch.optim import AdamW, cosine_schedule

    B, S, n = TRAIN["batch"], TRAIN["seq"], TRAIN["remat_off_steps"]
    cfg = dataclasses.replace(cfg, remat=False)
    model = init_model(0, cfg, device=dev)
    opt = AdamW(lr=cosine_schedule(3e-4, TRAIN["cli_steps"] // 10,
                                   TRAIN["cli_steps"]))
    state = opt.init(reference_leaves(model, cfg))
    step = make_train_step(cfg, opt)
    data = SyntheticLM(cfg.vocab, S, B, seed=0)
    sync(dev)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    walls, losses = [], []
    for i in range(n):
        batch = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in data.batch(i).items()}
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        sync(dev)
        walls.append(time.perf_counter() - t0)
    r = dict(arch=cfg.name, remat=False, steps=n, losses=losses,
             step_ms_median=statistics.median(walls[1:]) * 1e3,
             peak_memory=torch.cuda.max_memory_allocated(dev) if cuda else 0)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 17: {cfg.name} without remat: {r}")
    return r


def leaf_names(model, cfg) -> dict:
    """{reference leaf path: [parameter names in layer order]}."""
    from repro_torch.interop import reference_leaves

    name_of = {id(p): n for n, p in model.named_parameters()}
    return {path: [name_of[id(p)] for p in
                   (leaf if isinstance(leaf, list) else [leaf])]
            for path, leaf in reference_leaves(model, cfg).items()}


def leaf_gaps(names: dict, got: dict, want: dict, dev) -> tuple:
    """The worst reference leaf of ``got`` against ``want`` ({name:
    tensor}, want's on any device): (max |diff| / max |want| over the
    leaf, its path, its max |want|)."""
    worst = (0.0, None, 0.0)
    for path, ns in names.items():
        err = max(float((got[n] - want[n].to(dev)).abs().max()) for n in ns)
        scale = max(float(want[n].abs().max()) for n in ns)
        rel = err / scale if scale else (0.0 if err == 0 else math.inf)
        if rel >= worst[0]:
            worst = (rel, "/".join(path), scale)
    return worst


def grad_hold(cfg32, dev, B: int, S: int, seed: int) -> tuple[dict, object]:
    """float32 weights of ``cfg32`` drawn on the card; the loss and every
    reference leaf's gradient of B x S tokens (``lm.loss_and_grads``,
    rematerialised as the config asks), card against the same weights on
    the CPU: the loss within loss_rtol, each leaf within grad_rel of its
    max |g|. Returns the result and (the card's model, the CPU's
    gradients)."""
    import torch
    from repro_torch.models import init_model, lm, transformer

    model = init_model(torch.Generator(device=dev).manual_seed(0), cfg32,
                       device=dev)
    host = transformer.LM(cfg32, "cpu")
    host.load_state_dict(model.state_dict())
    batch = train_batch(cfg32, B, S, seed, "cpu")
    t0 = time.perf_counter()
    loss, metrics, grads = lm.loss_and_grads(
        model, {k: v.to(dev) for k, v in batch.items()}, cfg32)
    sync(dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, metrics_h, grads_h = lm.loss_and_grads(host, batch, cfg32)
    cpu_s = time.perf_counter() - t0
    del host
    names = leaf_names(model, cfg32)
    rel, path, scale = leaf_gaps(names, grads, grads_h, dev)
    r = dict(arch=cfg32.name, layers=cfg32.n_layers,
             enc_layers=cfg32.n_enc_layers, batch=B, seq=S,
             params=sum(p.numel() for p in model.parameters()),
             loss=float(loss), loss_cpu=float(loss_h),
             loss_rel=abs(float(loss) - float(loss_h)) / abs(float(loss_h)),
             aux=float(metrics["aux"]), aux_cpu=float(metrics_h["aux"]),
             worst_leaf=path, worst_leaf_rel=rel, worst_leaf_max=scale,
             leaves=len(names), card_seconds=card_s,
             cpu_seconds=cpu_s, grad_rel=TRAIN["grad_rel"],
             loss_rtol=TRAIN["loss_rtol"])
    del grads
    if not math.isfinite(r["loss"]) or r["loss_rel"] > TRAIN["loss_rtol"] \
            or rel > TRAIN["grad_rel"]:
        raise AssertionError(f"phase 17: {cfg32.name} gradients card "
                             f"against CPU: {r}")
    return r, (model, grads_h)


def adam_hold(model, cfg32, grads_h: dict, dev) -> dict:
    """One AdamW update (the CLI's lr at its first step) of the card's
    weights and of a CPU copy, both from the CPU's gradients: each new
    weight within adam_rel of its leaf's max |change| plus 2 float32 ulps
    of the weight (a change of ~lr moves a weight of 1 by ~1e3 ulps, so
    one ulp of rounding is a 1e-3 share of it), the moments within
    adam_rel of their leaf's max."""
    import torch
    from repro_torch.interop import reference_leaves
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW, cosine_schedule

    host = transformer.LM(cfg32, "cpu")
    host.load_state_dict(model.state_dict())
    before = {n: p.detach().clone() for n, p in host.named_parameters()}
    opt = AdamW(lr=cosine_schedule(3e-4, TRAIN["cli_steps"] // 10,
                                   TRAIN["cli_steps"]))
    out = {}
    for where, m, gs in (("card", model, {n: g.to(dev) for n, g in
                                          grads_h.items()}),
                         ("cpu", host, grads_h)):
        leaves = reference_leaves(m, cfg32)
        by_id = {id(p): gs[n] for n, p in m.named_parameters()}
        g_leaves = {k: [by_id[id(p)] for p in v] if isinstance(v, list)
                    else by_id[id(v)] for k, v in leaves.items()}
        state = opt.init(leaves)
        sync(dev)
        t0 = time.perf_counter()
        _, state = opt.update(leaves, g_leaves, state)
        sync(dev)
        names = leaf_names(m, cfg32)
        flat = {mom: {n: t for path, ns in names.items() for n, t in
                      zip(ns, state[mom][path] if isinstance(
                          state[mom][path], list) else [state[mom][path]])}
                for mom in ("m", "v")}
        out[where] = dict(seconds=time.perf_counter() - t0, flat=flat,
                          params=dict(m.named_parameters()))
    names = leaf_names(model, cfg32)
    eps = float(torch.finfo(torch.float32).eps)
    worst = dict(ratio=0.0, leaf=None)
    for path, ns in names.items():
        dmax = max(float((out["cpu"]["params"][n].detach() - before[n])
                         .abs().max()) for n in ns)
        for n in ns:
            want = out["cpu"]["params"][n].detach()
            err = (out["card"]["params"][n].detach().cpu() - want).abs()
            ratio = float((err / (TRAIN["adam_rel"] * dmax + 2 * eps
                                  * want.abs())).max())
            if ratio >= worst["ratio"]:
                worst = dict(ratio=ratio, leaf="/".join(path),
                             max_change=dmax)
    r = dict(arch=cfg32.name, card_update_seconds=out["card"]["seconds"],
             cpu_update_seconds=out["cpu"]["seconds"], weights=worst)
    for mom in ("m", "v"):
        rel, path, scale = leaf_gaps(names, out["card"]["flat"][mom],
                                     out["cpu"]["flat"][mom], dev)
        r[mom] = dict(worst_leaf=path, rel=rel, max=scale)
    if worst["ratio"] > 1 or r["m"]["rel"] > TRAIN["adam_rel"] or \
            r["v"]["rel"] > TRAIN["adam_rel"]:
        raise AssertionError(f"phase 17: AdamW card against CPU: {r}")
    return r


def train_steps_bf16(model, cfg, dev, seed: int, compress: str) -> dict:
    """bf16_steps train steps of ``cfg`` (bf16 compute on ``model``'s
    float32 weights, its micro_batches, remat), each on a fresh batch of
    B = max(hold_B, micro_batches) sequences of bf16_S tokens, each
    step's host wall ended by a synchronise; ``compress``: the
    optimizer's grad_compress."""
    import torch
    from repro_torch.interop import reference_leaves
    from repro_torch.models import make_train_step
    from repro_torch.optim import AdamW

    k = max(1, cfg.micro_batches)
    B, S = max(TRAIN["hold_B"], k), TRAIN["bf16_S"]
    opt = AdamW(lr=3e-4, grad_compress=compress)
    state = opt.init(reference_leaves(model, cfg))
    step = make_train_step(cfg, opt)
    first = next(model.parameters()).detach().clone()
    sync(dev)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    walls, losses = [], []
    for i in range(TRAIN["bf16_steps"]):
        batch = train_batch(cfg, B, S, seed + i, dev)
        t0 = time.perf_counter()
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        sync(dev)
        walls.append(time.perf_counter() - t0)
    moved = float((next(model.parameters()) - first).abs().max())
    r = dict(arch=cfg.name, dtype=cfg.dtype, micro_batches=k, batch=B,
             seq=S, grad_compress=compress, losses=losses,
             step_ms=[w * 1e3 for w in walls], moved=moved,
             peak_memory=torch.cuda.max_memory_allocated(dev) if cuda else 0)
    if not all(math.isfinite(x) for x in losses) or moved == 0:
        raise AssertionError(f"phase 17: {cfg.name} bf16 steps: {r}")
    return r


def run_train(tmp: Path, dev, smi: str) -> dict:
    """Phase 17: (a) the training CLI at full width and depth, timed in
    this process (one more step profiled), and its resume in a second
    process; a few steps without remat (peak memory); (b) float32 gradients and AdamW's
    update card against CPU at full width; (c) the other families at full
    width cut in depth: float32 gradients card against CPU, then bf16
    train steps."""
    import torch
    from repro_torch.configs import get_config

    out: dict = {"gpu": smi}
    out["cli"] = run_train_cli(tmp, dev)
    log(f"[17] cli {json.dumps(out['cli'])}")
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN["arch"])
    out["remat_off"] = remat_off_steps(cfg, dev)
    log(f"[17] remat_off {json.dumps(out['remat_off'])}")
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out["hold"], (model, grads_h) = grad_hold(cfg32, dev, TRAIN["hold_B"],
                                              TRAIN["hold_S"], seed=170)
    log(f"[17] hold {json.dumps(out['hold'])}")
    out["adam"] = adam_hold(model, cfg32, grads_h, dev)
    log(f"[17] adam {json.dumps(out['adam'])}")
    del model, grads_h
    torch.cuda.empty_cache()

    out["cut"] = []
    for arch, n in TRAIN["cut"].items():
        full = get_config(arch)
        cut = dataclasses.replace(
            full, n_layers=n, n_enc_layers=n if full.n_enc_layers else 0)
        hold, (model, grads_h) = grad_hold(
            dataclasses.replace(cut, dtype="float32"), dev, TRAIN["hold_B"],
            TRAIN["cut_S"], seed=171)
        del grads_h
        stamp(f"[17] {arch}: float32 gradients card against CPU")
        hold["bf16"] = train_steps_bf16(
            model, cut, dev, seed=172,
            compress="int8" if arch in TRAIN["int8"] else "none")
        out["cut"].append(hold)
        log(f"[17] cut {json.dumps(hold)}")
        del model
        torch.cuda.empty_cache()
    return out


def log_train(tr: dict, smi: str) -> None:
    """Phase 17's summary lines (run_train logs each part's JSON line as
    it ends)."""
    c, off, p = tr["cli"], tr["remat_off"], tr["cli"]["profile"]
    for line in c["lines"] + c["resume_lines"]:
        log(f"[17] CLI (repro_torch.launch.train --arch {c['arch']}): {line}")
    log(f"[17] CLI {c['arch']} (bf16, remat) B={c['batch']} S={c['seq']}, "
        f"{c['steps']} steps in {c['seconds']:.1f} s: median step "
        f"{c['step_ms_median']:.2f} ms (min {c['step_ms_min']:.2f}, max "
        f"{c['step_ms_max']:.2f}) over steps {c['time_from']}-{c['steps']}, "
        f"{c['tokens_per_s']:,.0f} tok/s ({c['cli_tokens_per_s']:,.0f} "
        f"by the CLI's last line, checkpoints included), loss "
        f"{c['first_loss']} -> {c['last_loss']}; peak device memory "
        f"{c['peak_memory']} bytes ({c['memory_held_before']} held before; "
        f"remat off: {off['peak_memory']}, median step "
        f"{off['step_ms_median']:.2f} ms); one profiled step: wall "
        f"{p.get('wall_s', 0) * 1e3:.2f} ms, {p.get('kernels')} kernels "
        f"taking {p.get('wall_s', 0) * p.get('busy_share', 0) * 1e3:.2f} ms"
        f" of device time, busy {p.get('busy_share', 0):.3f}; resumed from "
        f"step {c['resume_from']} in a second process "
        f"({c['resume_seconds']:.1f} s): losses within "
        f"{c['resume_max_rel']:.3g} relative (limit {c['resume_limit']}); "
        f"gpu: {smi}")
    for v in [tr["hold"]] + tr["cut"]:
        log(f"[17] {v['arch']} float32 ({v['layers']} layers, {v['params']} "
            f"parameters, B={v['batch']} S={v['seq']}) card vs CPU: loss "
            f"{v['loss']:.7g} vs {v['loss_cpu']:.7g} (rel {v['loss_rel']:.3g},"
            f" limit {v['loss_rtol']}), worst leaf {v['worst_leaf']} at "
            f"{v['worst_leaf_rel']:.3g} of its max |g| (limit "
            f"{v['grad_rel']}); card {v['card_seconds']:.2f} s, CPU "
            f"{v['cpu_seconds']:.1f} s")
        if "bf16" in v:
            b = v["bf16"]
            log(f"[17] {v['arch']} bf16 train steps (micro_batches "
                f"{b['micro_batches']}, B={b['batch']} S={b['seq']}, "
                f"grad_compress {b['grad_compress']}): losses "
                f"{[round(x, 4) for x in b['losses']]}, "
                f"{[round(x, 1) for x in b['step_ms']]} ms, peak device "
                f"memory {b['peak_memory']} bytes")
    a, w = tr["adam"], tr["adam"]["weights"]
    log(f"[17] AdamW card vs CPU on the CPU's gradients ({a['arch']}): "
        f"new weights worst leaf {w['leaf']} at {w['ratio']:.3g} of its "
        f"limit (its max change {w['max_change']:.3g}), m "
        f"{a['m']['rel']:.3g}, v {a['v']['rel']:.3g} of their max (limit "
        f"{TRAIN['adam_rel']}); "
        f"update "
        f"{a['card_update_seconds'] * 1e3:.1f} ms on the card, "
        f"{a['cpu_update_seconds'] * 1e3:.0f} ms on the CPU")


# --------------------------------------------------------------------------
# phase 19: the dry run on the card
# --------------------------------------------------------------------------


def kinds(counts: dict) -> dict:
    """Counts by the port's collective names as the dry run's kinds
    (nonzero only)."""
    from repro_torch.launch import dryrun

    out: dict = {}
    for op, n in counts.items():
        if n:
            out[dryrun.KIND[op]] = out.get(dryrun.KIND[op], 0) + n
    return out


def dryrun_ibp(dev, tmp: Path) -> tuple[dict, dict]:
    """The IBP cell under each sync, its launches and all-reduces held;
    then the four kernels at its shapes against their plain versions.
    Returns (the cells' records and holds, the launches of both cells)."""
    import torch

    from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
    from repro_torch.data import cambridge_data
    from repro_torch.launch import dryrun

    d, L = DRYRUN, DRYRUN["L"]
    out, launches = {}, {}
    for sync in ("staged", "fused"):
        rec = dryrun.run_ibp_cell(d["ibp_mesh"], N=d["N"], K_max=d["K_max"],
                                  K_tail=d["K_tail"], L=L, sync=sync,
                                  device=dev, force=True, out_dir=str(tmp))
        if rec["status"] != "ok":
            raise AssertionError(f"phase 19: the IBP cell ({sync}): "
                                 f"{rec.get('error')}\n{rec.get('traceback')}")
        want = dict(gibbs_flip=L, collapsed_scan=L, feature_stats=1,
                    gaussian_sse=1 if sync == "staged" else 0)
        want = {k: v for k, v in want.items() if v}
        ar = rec["collectives"]["counts"]["all-reduce"]
        if rec["launches"] != want or ar != (3 if sync == "staged" else 1):
            raise AssertionError(
                f"phase 19: the IBP cell ({sync}) launched "
                f"{rec['launches']} (want {want}) with {ar} all-reduces")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        out[sync] = rec
        stamp(f"[19] IBP cell {sync}")
    N_p = d["N"] // out["staged"]["P"]
    X = cambridge_data(N=d["N"], seed=0)[0][:N_p]
    s = build_sampler(SamplerSpec(P=1, L=L, K_max=d["K_max"],
                                  K_tail=d["K_tail"]), IBPHypers(), X,
                      device=dev)
    gs, ss = s.init()
    for _ in range(d["hold_iters"]):
        gs, ss = s.step(gs, ss)
    torch.cuda.synchronize()
    out["kernels"] = rank_kernels(s, gs, ss, 19)
    out["scan"] = scan_variant(dev, N_p, d["K_tail"], X.shape[1], 119,
                               hold_rows=d["scan_hold_rows"])
    for r in (*out["kernels"].values(), out["scan"]):
        r["shape"] += " (phase 19: the IBP cell's shapes)"
    return out, launches


def dryrun_lm(dev, tmp: Path, lm_mesh: dict) -> dict:
    """The LM cells' depth probes on fake cuda tensors, each ok with the
    device's allocated memory unchanged; phase 18's bf16 step dry-run
    against phase 18's counted steps and rank 0's measured peak, and the
    same step on real tensors against the tracker."""
    import torch

    from repro_torch import parallel
    from repro_torch.configs import ALL_SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.parallel import mesh as pmesh

    out = dict(cells=[])
    for arch, shape, mesh in DRYRUN["cells"]:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        rec = dryrun.run_probe(arch, next(x for x in ALL_SHAPES
                                          if x.name == shape), mesh,
                               force=True, device=dev, out_dir=str(tmp))
        rec["allocated_change"] = torch.cuda.memory_allocated(dev) - before
        if rec["status"] != "ok" or rec["allocated_change"]:
            raise AssertionError(
                f"phase 19: {arch} {shape} {mesh}: {rec.get('error')} "
                f"(allocated change {rec['allocated_change']})\n"
                f"{rec.get('traceback')}")
        out["cells"].append(rec)
        stamp(f"[19] {arch} {shape} {mesh}")
    s = LM_MESH
    cfg = get_config(s["arch"])
    shape = ShapeConfig("phase18", s["seq"], s["batch"], "train")
    before = torch.cuda.memory_allocated(dev)
    rec = dryrun.trace_step(cfg, shape,
                            pmesh.mesh_shape(s["shape"], ("data", "model")),
                            device=dev)
    rec["allocated_change"] = torch.cuda.memory_allocated(dev) - before
    # the same step on real tensors of the card, rank 0 of the same fake
    # world: the allocator's peak over it above what was allocated before
    # its build, less what stays allocated once the step's tensors are
    # freed (cuBLAS workspaces this process had not made yet: the
    # tracker does not count them), against the tracker's peak
    with parallel.fake_world(0, math.prod(s["shape"]), dev) as w:
        mesh = parallel.make_mesh(s["shape"], ("data", "model"))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step, args = dryrun.build_step(cfg, shape, mesh, device=w.device)
        _, _, mem, _ = dryrun.measure(step, args, w.device.type)
        torch.cuda.synchronize()
        peak_real = torch.cuda.max_memory_allocated(dev) - base
        del step, args
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated(dev) - base
    real = dict(allocator=peak_real - kept, kept=kept, tracker=mem.peak)
    torch.cuda.empty_cache()
    if abs(real["allocator"] - real["tracker"]) > 0.01 * real["tracker"] \
            or real["tracker"] != (rec["memory"]["peak_bytes"]
                                   - rec["memory"]["workspace_bytes"]):
        raise AssertionError(f"phase 19: phase 18's step on real tensors: "
                             f"{real} against the estimate {rec['memory']}")
    got = {g: {k: v for k, v in c["counts"].items() if v}
           for g, c in rec["collectives_by_group"].items()}
    got["all"] = {k: v for k, v in rec["collectives"]["counts"].items()
                  if v}
    r0 = lm_mesh["ranks"][0]
    steps = [{g: kinds(c) for g, c in st["collectives"].items() if kinds(c)}
             for st in r0["bf16"]["steps"]]
    peak = r0["bf16"]["peak"]
    ratio = rec["memory"]["peak_bytes"] / peak
    lo, hi = DRYRUN["peak_band"]
    if any(st != got for st in steps) or not lo <= ratio <= hi or \
            rec["allocated_change"]:
        raise AssertionError(
            f"phase 19: phase 18's step dry-run: collectives {got} vs "
            f"phase 18's {steps}; peak estimate {rec['memory']} against "
            f"{peak} ({ratio:.4f}, band {DRYRUN['peak_band']}); allocated "
            f"change {rec['allocated_change']}")
    out["phase18"] = dict(rec, counts=got, measured_peak=peak, ratio=ratio,
                          peaks=[r["bf16"]["peak"] for r in
                                 lm_mesh["ranks"]], real=real)
    return out


def run_dryrun(dev, lm_mesh: dict) -> tuple[dict, dict]:
    """Phase 19 (the module docstring says what it runs). Returns (its
    results, the kernels' launches in the IBP cells)."""
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode  # noqa
        from torch.testing._internal.distributed.fake_pg import (  # noqa
            FakeStore,
        )
    except ImportError as e:
        raise AssertionError(f"phase 19: this torch lacks the fake process "
                             f"group or fake tensors: {e}") from e
    with tempfile.TemporaryDirectory() as tmpdir:
        ibp, launches = dryrun_ibp(dev, Path(tmpdir))
        lm = dryrun_lm(dev, Path(tmpdir), lm_mesh)
    return dict(ibp=ibp, **lm), launches


def log_dryrun(v: dict, smi: str) -> None:
    for sync in ("staged", "fused"):
        r = v["ibp"][sync]
        c = r["collectives"]
        log(f"[19] IBP cell {r['mesh']} ({sync}): N={r['global_batch']} "
            f"over P={r['P']} (rank {r['rank']}: {r['rows_per_rank']} rows, "
            f"D={r['seq_len']}, K_max={r['K_max']}, K_tail={r['K_tail']}, "
            f"L={r['L']}): one real iteration {r['wall_s']:.4f} s, launches "
            f"{r['launches']}, collectives {c['counts']} ({c['total']} "
            f"bytes), peak device memory {r['memory']['peak_bytes']} bytes, "
            f"aten FLOPs {r['flops']:.4g}; the whole cell {r['trace_s']} s; "
            f"gpu: {smi}")
    for name, r in (*v["ibp"]["kernels"].items(),
                    ("collapsed_scan", v["ibp"]["scan"])):
        log(f"[19] {name} {r['shape']}: ms={r['ms']:.4f} call_ms="
            f"{r['call_ms']:.4f} plain_ms={r.get('plain_ms', 0.0):.4f} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) library_ms="
            f"{r.get('library_ms')} max_abs_err={r.get('max_abs_err')}")
    for r in v["cells"]:
        p, L1, L2 = r["probes"], r["L1"], r["L2"]
        f1, f2 = p[str(L1)]["flops"], p[str(L2)]["flops"]
        full = f1 + (r["L"] - L1) / (L2 - L1) * (f2 - f1)
        log(f"[19] {r['arch']} {r['shape']} {r['mesh']} at full width on "
            f"fake cuda tensors, the depth probes of {L1} and {L2} layers "
            f"(the full model's parameter bytes): {r['status']}, "
            f"{json.dumps(p)}; extrapolated to {r['L']} layers {full:.6g} "
            f"FLOPs a card; allocated change {r['allocated_change']}")
    p = v["phase18"]
    log(f"[19] phase 18's bf16 step dry-run ({LM_MESH['arch']}, "
        f"{LM_MESH['shape']} mesh, B={LM_MESH['batch']} "
        f"S={LM_MESH['seq']}): collectives {p['counts']}, equal to each "
        f"of phase 18's steps; peak estimate {p['memory']['peak_bytes']} "
        f"bytes ({p['memory']['workspace_bytes']} of them cuBLAS "
        f"workspaces) against rank 0's measured {p['measured_peak']} "
        f"({p['ratio']:.4f}; band {DRYRUN['peak_band']}; the ranks' "
        f"{p['peaks']}); in {p['trace_s']} s. The same step on real "
        f"tensors of the card in a fake world: the allocator's peak above "
        f"its base {p['real']['allocator']} bytes ({p['real']['kept']} "
        f"more kept after it), the tracker's {p['real']['tracker']}")


def main() -> int:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the "
              "port on a GPU only", file=sys.stderr)
        return 2
    from repro_torch import device as port_device
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"[1] gpu: {smi}")
    dev = port_device.resolve("cuda")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # phase 2: build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[2] built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in sorted(logs.items()):
        for line in out.splitlines():
            if "Used " in line or "spill" in line:
                log(f"[2]   {name}: {line.strip()}")

    sass = sass_hmma(KERNELS)
    for name, counts in sass.items():
        log(f"[2]   {name} SASS HMMA per kernel instance: {counts}")

    # phase 3: kernels against their plain versions
    t0 = time.perf_counter()
    results = {r["name"]: r for r in
               [check_gibbs_flip(dev), check_collapsed_row(dev),
                check_collapsed_scan(dev), *check_stats_kernels(dev)]}
    for r in results.values():
        log(f"[3] {r['name']} {r['shape']}: ms={r['ms']:.4f} "
            f"call_ms={r['call_ms']:.4f} ({r['timing']}) "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={r['library_ms']} "
            f"max_abs_err={r['max_abs_err']}")
        for v in r.get("variants", []):
            log(f"[3]   {v}")
    log(f"[3] kernel checks took {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        # phase 4: the CLI
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = run_cli(tmp)
        cli_counts = launch_counts()
        log(f"[4] CLI: {time.perf_counter() - t0:.1f} s, launches "
            f"{cli_counts}")
        for r in hist:
            log(f"[4] {json.dumps(r)}")
        # phase 5: full width through the driver
        data = full_data()
        full, full_counts, phase5 = run_full_width(tmp, smi, data)
        log(f"[5] full width: {json.dumps(full)}")
        log(f"[5] launches {full_counts}")

        # phase 7: capacity growth, K_tail growth, shrink
        t0 = time.perf_counter()
        growth, growth_counts, grown = run_growth(tmp, data, dev)
        log(f"[7] growth: {json.dumps(growth)}")
        log(f"[7] launches {growth_counts}")
        log(f"[7] s/iteration at K_max={growth['K_max']} by K_tail: "
            f"{growth['seconds_per_iteration_by_K_tail']}")
        log(f"[7] tail ms/row by K_tail: " + ", ".join(
            f"{k}: {v['tail_ms_per_row']:.5f}"
            for k, v in growth["tail"].items()))
        for name, v in grown.items():
            log(f"[7] {name} {v['shape']}: ms={v['ms']:.4f} "
                f"bound_ms={v['bound_ms']:.4f} plain_ms={v['plain_ms']:.4f} "
                f"library_ms={v.get('library_ms')}")
        log(f"[7] shrunk to K_max={growth['shrunk_K_max']} "
            f"(K+={growth['shrunk_K']}); phase took "
            f"{time.perf_counter() - t0:.1f} s")

        # phase 8: the serial uncollapsed baseline
        t0 = time.perf_counter()
        base, base_counts, base_sweep = run_baseline(dev, data)
        log(f"[8] baseline: {json.dumps(base)}")
        log(f"[8] launches {base_counts}")
        log(f"[8] gibbs_flip {base_sweep['shape']}: ms={base_sweep['ms']:.4f} "
            f"(phase 3, 40 of 64 active: {results['gibbs_flip']['ms']:.4f}) "
            f"bound_ms={base_sweep['bound_ms']:.4f}; phase took "
            f"{time.perf_counter() - t0:.1f} s")

    # phase 9: the serial collapsed sampler
    t0 = time.perf_counter()
    coll, coll_counts = run_collapsed(dev, data)
    log(f"[9] collapsed: {json.dumps(coll)}")
    log(f"[9] launches {coll_counts}")
    log(f"[9] s/sweep at K_max={coll['K_max']}, N={coll['N']}, "
        f"D={coll['D']}: median {coll['median_seconds_per_sweep']:.4f} "
        f"(min {coll['min_seconds_per_sweep']:.4f}, max "
        f"{coll['max_seconds_per_sweep']:.4f}), {coll['ms_per_row']:.5f} "
        f"ms/row, {coll['rows_per_s']:.0f} rows/s, K+ {coll['K_plus']}, "
        f"sigma_x {coll['sigma_x']:.4f}, alpha {coll['alpha']:.4f}")
    for i, mv in enumerate(coll["sigma_moves"]):
        log(f"[9] sweep {i} sigma moves (replayed, equal to the sampler's): "
            f"{json.dumps(mv)}")
    log(f"[9] collapsed_loglik at sigma_x, exp(0.1) sigma_x and exp(-0.1) "
        f"sigma_x, and the two differences: float32 {coll['loglik_f32']}, "
        f"float64 {coll['loglik_f64']}; the float32 up-difference is off by "
        f"{coll['loglik_diff_rounding']:.4f}")
    pre = coll["scan_prefix"]
    log(f"[9] collapsed_scan {pre['shape']} against the plain scan: "
        f"{pre['decisions_differing']} decisions differ, boundary event "
        f"{pre['boundary_event']}, counts equal {pre['counts_equal']}, Z equal "
        f"to the sweep's own rows; plain_ms={pre['plain_ms']:.1f} (on "
        f"{pre['plain_device']}), "
        f"{pre['seconds']:.1f} s")
    for v in coll["stats"]:
        log(f"[9] feature_stats {v['shape']}: ms={v['ms']:.4f} "
            f"bound_ms={v['bound_ms']:.4f} plain_ms={v['plain_ms']:.4f} "
            f"max_abs_err={v['max_abs_err']}")
    log(f"[9] one sweep profiled: {json.dumps(coll['sweep_profile'])}")
    k = coll["scan_kernel"]
    log(f"[9] collapsed_scan {k['shape']}: ms={k['ms']:.2f} "
        f"call_ms={k['call_ms']:.2f} ({k['timing']}) "
        f"ms/row={k['ms_per_row']:.5f} bound_ms={k['bound_ms']:.4f} "
        f"({k['bound_by']}), {k['k_live']:.0f} live columns")
    log(f"[9] s/sweep at K_max={coll['wide_K_max']}: "
        f"{coll['wide_seconds_per_sweep']:.4f} "
        f"({coll['wide_ms_per_row']:.5f} ms/row); peak device memory "
        f"{coll['max_memory_allocated']} bytes; phase took "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 10: the packed collapsed carry
    t0 = time.perf_counter()
    packed, packed_counts = run_packed(dev, data, phase5)
    log(f"[10] packed: {json.dumps(packed)}")
    log(f"[10] launches {packed_counts}")
    for v in packed["holds"]:
        log(f"[10] collapsed_scan {v['shape']} against the plain scan: "
            f"{v['decisions_differing']} decisions differ, boundary event "
            f"{v['boundary_event']}, counts equal {v['counts_equal']}, "
            f"ovf_row {v['ovf_row']} (plain {v['plain_ovf_row']}), "
            f"{v['k_live']:.0f} live after; ms={v.get('ms', float('nan')):.3f}"
            f" ms/row={v.get('ms_per_row', float('nan')):.5f} "
            f"bound_ms={v.get('bound_ms', float('nan')):.5f} "
            f"plain_ms={v['plain_ms']:.1f} (on {v['plain_device']})")
    for backend, v in packed["sweeps"].items():
        log(f"[10] {backend}, k_live_buckets=on, K_max={packed['K_max']}: "
            f"warm sweep {v['warm'][0]['seconds']:.4f} s, seg_log "
            f"{v['warm'][0]['seg_log']}, K+ {v['warm'][0]['K_plus']}; timed "
            f"{[round(r['seconds'], 4) for r in v['timed']]} s, median "
            f"{v['median_seconds_per_sweep']:.4f} s/sweep, "
            f"{v['ms_per_row']:.5f} ms/row, buckets "
            f"{[r['seg_log'] for r in v['timed']]}, K+ "
            f"{[r['K_plus'] for r in v['timed']]}, device busy "
            f"{v['profile']['busy_share']:.4f}")
        log(f"[10] {backend} on the same final state and draws: off "
            f"{v['same_state_off_seconds']:.4f} s, on "
            f"{v['same_state_on_seconds']:.4f} s (bucket "
            f"{v['same_state_bucket']})")
    for backend, v in packed["settled"].items():
        log(f"[10] {backend} from a state with K+ {v['K_plus_in']} of "
            f"{packed['K_max']} (sigma_x 0.5): off {v['off_seconds']:.4f} s "
            f"(K+ {v['K_plus_off']}), on {v['on_seconds']:.4f} s (seg_log "
            f"{v['on_seg_log']}, K+ {v['K_plus_on']}), "
            f"{v['decisions_differing']} bits differ between the two")
    for backend, v in packed["hybrid"].items():
        log(f"[10] phase 5 under collapsed_backend={backend}: "
            f"{v['seconds_per_iteration']:.4f} s/iteration "
            f"({[round(t, 4) for t in v['iterations']]}), tail "
            f"{v['tail_ms_per_row']:.5f} ms/row")
    log(f"[10] phase took {time.perf_counter() - t0:.1f} s")

    # phase 11: posterior-predictive serving
    t0 = time.perf_counter()
    serving, serving_counts, bank = run_serving(dev, data)
    log(f"[11] serving: {json.dumps(serving)}")
    h = serving["harvest"]
    log(f"[11] harvest: S={h['S']} samples at iterations {h['its']}, K "
        f"bucket {h['K_bucket']} of K_max={FULL['K_max']}, K+ per sample "
        f"{h['K_plus']}; {h['seconds_per_iteration']:.4f} s/iteration "
        f"(phase 5: {full['seconds_per_iteration']:.4f}), the harvest's "
        f"host work {h['harvest_seconds_per_iteration']:.5f} s/iteration; "
        f"the loaded bank equals the built one bitwise")
    log(f"[11] launches of the harvest run and the naive scorer "
        f"{serving_counts}")
    for v in serving["holds"]:
        log(f"[11] scorer card vs CPU ({'masked' if v['masked'] else 'unmasked'},"
            f" {v['rows']} rows, S={h['S']}): {v['bits_differing']} Z bits "
            f"differ, boundary events {v['boundary_events']}; max |dprobs| "
            f"{v['max_abs_dprobs']:.3g} (tol {v['dprobs_tol']}), max rel "
            f"|dll| {v['max_rel_dll']:.3g} (tol {v['dll_rel_tol']})")
    e = serving["enumeration"]
    log(f"[11] encode (n_sweeps={e['n_sweeps']}) vs exact_posterior, K "
        f"{e['K_live']} live of bucket {e['K_bucket']}, D={e['D']}, "
        f"{e['rows']} rows: max |err| {e['max_abs_err']:.4f} (tol "
        f"{e['tol']:.4f}), mean {e['mean_abs_err']:.4f}")
    for op, v in serving["serve"].items():
        log(f"[11] serve {op}: {v['rows_per_s']:.0f} rows/s, p50 "
            f"{v['latency_p50_us']:.0f} us, p95 {v['latency_p95_us']:.0f} us,"
            f" warm-up {v['warmup_s']:.2f} s, {v['requests']} requests / "
            f"{v['rows']} rows; a {v['dispatch_rows']}-row dispatch: "
            f"{v['launches_per_dispatch']} launches, device busy "
            f"{v['dispatch_busy_share']:.4f}; peak "
            f"{v['max_memory_allocated']} bytes")
    pl = serving["planted"]
    v = pl["serve"]["loglik"]
    log(f"[11] serve loglik, planted bank (S={pl['S']}, K bucket "
        f"{pl['K_bucket']}): {v['rows_per_s']:.0f} rows/s, p50 "
        f"{v['latency_p50_us']:.0f} us, p95 {v['latency_p95_us']:.0f} us; a "
        f"{v['dispatch_rows']}-row dispatch: {v['launches_per_dispatch']} "
        f"launches, device busy {v['dispatch_busy_share']:.4f}; peak "
        f"{v['max_memory_allocated']} bytes")
    for tag, n in (("harvested", serving["naive"]), ("planted", pl["naive"])):
        log(f"[11] naive vs batched predictive_loglik ({tag} bank) on "
            f"{n['rows']} rows, S={n['S']}: {n['naive_seconds']:.4f} s vs "
            f"{n['batched_seconds']:.4f} s, ratio "
            f"{n['naive_over_batched']:.3f}; naive gibbs_flip launches "
            f"{n['naive_gibbs_flip_launches']}")
    for g in serving["gibbs_flip_naive"]:
        log(f"[11] gibbs_flip {g['shape']}: ms={g['ms']:.4f} "
            f"call_ms={g['call_ms']:.4f} bound_ms={g['bound_ms']:.5f} "
            f"plain_ms={g['plain_ms']:.4f}")
    for lines in serving["cli"]["lines"]:
        log(f"[11] CLI: {lines}")
    log(f"[11] phase took {time.perf_counter() - t0:.1f} s")

    # phase 12: C independent chains on one card
    t0 = time.perf_counter()
    multi, multi_counts, stale_counts = run_chains(dev, data)
    d = multi["drive"]
    log(f"[12] multichain: {json.dumps(multi)}")
    log(f"[12] launches of {d['iters']} iterations {multi_counts}; of one "
        f"iteration with stale_sync=1 {stale_counts}")
    log(f"[12] s/iteration at C={d['C']}: {d['seconds_per_iteration']:.4f} "
        f"(phase 5, one chain: {full['seconds_per_iteration']:.4f}); "
        f"resumed to it={d['resumed_to']}: "
        f"{d['resumed_seconds_per_iteration']:.4f} s/iteration; with "
        f"stale_sync=1: {d['stale_iteration_seconds']:.4f} s for one "
        f"iteration; peak {d['max_memory_allocated']} bytes")
    r = d["resumed_record"]
    log(f"[12] eval at it={r['it']}: R-hat sigma_x {r['sigma_x_rhat']}, K "
        f"{r['K_rhat']}; ESS sigma_x {r['sigma_x_ess']}, K {r['K_ess']}; "
        f"MCSE sigma_x {r.get('sigma_x_mcse')}; K per chain "
        f"{r['K_chains']}, sigma_x per chain {r['sigma_x_chains']}, "
        f"joint_ll_train per chain {r['joint_ll_train_chains']}, tail_sat "
        f"per chain {r['tail_sat_chains']}, joint_ll_eval "
        f"{r['joint_ll_eval']}")
    for v in multi["holds"]:
        log(f"[12] chained collapsed_scan {v['shape']} against the plain "
            f"scan: {v['decisions_differing']} decisions differ, boundary "
            f"events {v['boundary_events']}, counts equal "
            f"{v['counts_equal']}; each chain bitwise equal to its "
            f"single-chain launch; plain_ms={v['plain_ms']:.1f} (on "
            f"{v['plain_device']})")
    for v in multi["timing"]:
        log(f"[12] chained collapsed_scan {v['shape']}: ms={v['ms']:.3f} "
            f"call_ms={v['call_ms']:.3f} ({v['timing']}) "
            f"ms/row={v['ms_per_row']:.5f} bound_ms={v['bound_ms']:.5f} "
            f"({v['bound_by']}), launches a call {v['launches_per_call']}")
    log(f"[12] phase took {time.perf_counter() - t0:.1f} s")

    # phases 13 and 14: one spawn of P ranks runs both layouts' rank
    # work, one rank both worlds of one; phase 13's time includes it
    layouts_dir = tempfile.TemporaryDirectory()
    ltmp = Path(layouts_dir.name)
    # phase 13: the data-parallel layout on P ranks
    t0 = time.perf_counter()
    spawned = spawn_layouts(ltmp, data, phase5, bank)
    shard, shard_counts = run_shardmap(ltmp, data, phase5, dev, spawned)
    log(f"[13] shardmap: {json.dumps(shard)}")
    log(f"[13] launches of every rank, summed {shard_counts}")
    sw = shard["sweep"]
    log(f"[13] {shard['P']} ranks on cuda:0 over gloo, spawned and run in "
        f"{shard['spawn_seconds']:.1f} s with phase 14's work (the slowest "
        f"rank in rank_iterations after {shard['spawn_clock']['enter']} s, "
        f"phase 13's work done after {shard['spawn_clock']['done']} s); "
        f"the first sweep as one call vs each rank's block: "
        f"{sw['decisions_differing']} decisions differ, "
        f"{sw['boundary_events']} boundary events")
    for sync in ("staged", "fused"):
        v = shard[sync]
        c = v["vs_vmap"]
        log(f"[13] {sync}: {v['seconds_per_iteration']:.4f} s/iteration "
            f"({[round(t, 4) for t in v['iterations']]}; phase 5: "
            f"{full['seconds_per_iteration']:.4f}), collectives an "
            f"iteration {v['collectives_per_iteration']} taking "
            f"{v['collective_host_seconds_per_iteration']:.4f} s of host "
            f"time a rank (the wait for p′'s tail included), p' "
            f"{v['p_prime']}, K+ {v['K']}, sigma_x "
            f"{v['sigma_x']:.4f}")
        log(f"[13] {sync} launches a rank in iteration 1: "
            f"{v['launches_per_rank']}")
        log(f"[13] {sync} first iteration vs vmap: {c['z_bits_differing']} "
            f"Z bits differ, A max |diff| {c['A_max_abs_diff']:.3g} "
            f"({c['A_rel_max']:.3g} of max |A|), sigma_x {c['sigma_x']}, p' "
            f"{c['p_prime']} equal")
        c = v["replay"]
        log(f"[13] {sync} master replayed on the ranks' Z: A max |diff| "
            f"{c['A_max_abs_diff']:.3g} ({c['A_rel_max']:.3g} of max |A|, "
            f"limit {SHARDMAP['A_rtol']}), sigma_x {c['sigma_x']:.7g} "
            f"({c['sigma_x_rel']:.3g}, limit {SHARDMAP['sx_rtol']}), K+ "
            f"{c['K']}, p' equal")
    c = shard["fused_vs_staged"]
    log(f"[13] fused vs staged first iteration: {c['z_bits_differing']} Z "
        f"bits differ, A max |diff| {c['A_max_abs_diff']:.3g} "
        f"({c['A_rel_max']:.3g} of max |A|), sigma_x {c['sigma_x']}")
    v = shard["sse"]
    log(f"[13] SSE on the fused run's last state: identity "
        f"{v['identity']:.6g}, gaussian_sse {v['kernel']:.6g}, relative gap "
        f"{v['rel_gap']:.3g} (limit {SHARDMAP['sse_rtol']})")
    for name, v in shard["kernels"].items():
        log(f"[13] {name} {v['shape']}: ms={v['ms']:.4f} "
            f"call_ms={v['call_ms']:.4f} bound_ms={v['bound_ms']:.5f} "
            f"({v['bound_by']}) plain_ms={v['plain_ms']:.4f} library_ms="
            f"{v['library_ms']} max_abs_err={v['max_abs_err']:.3g}")
    log(f"[13] one all-reduce of n floats on the {shard['P']} ranks, the "
        f"device idle before it (ms, median of 10, the slowest rank): "
        f"{shard['all_reduce_ms']}")
    v = shard["stale"]
    log(f"[13] stale pass: {v['seconds']:.4f} s, collectives "
        f"{v['collectives']}, p' {v['p_prime']}")
    v = shard["nccl_one"]
    log(f"[13] NCCL world of one rank (P=1): {v['backend']}, one iteration "
        f"{v['seconds']:.4f} s, bitwise equal to the vmap layout at P=1: "
        f"{v['bitwise_equal']}")
    for line in shard["cli"]["lines"]:
        log(f"[13] CLI ({SHARDMAP['cli_ranks']} ranks, fused): {line}")
    log(f"[13] phase took {time.perf_counter() - t0:.1f} s")

    # phase 14: the chains x data mesh on C·P ranks
    t0 = time.perf_counter()
    mesh, mesh_counts = run_mesh(ltmp, data, phase5, bank, dev, spawned)
    lm_ranks, lm_clock = spawned["ranks18"], spawned["clock18"]
    del spawned
    layouts_dir.cleanup()
    log(f"[14] mesh: {json.dumps(mesh)}")
    log(f"[14] launches of every rank, summed {mesh_counts}")
    mp = mesh["mps"]
    log(f"[14] {mesh['C']} chains x {mesh['P']} shards = "
        f"{mesh['C'] * mesh['P']} ranks on cuda:0 over gloo (N_p={mesh['N_p']}), phase 13's ranks "
        f"(phase 14's work from {mesh['spawn_clock']['enter']} to "
        f"{mesh['spawn_clock']['done']} s after the spawn); MPS "
        f"{'active' if mp['active'] else 'not active'} (control pipe "
        f"{mp['control_pipe']} {'found' if mp['active'] else 'absent'}, "
        f"compute mode {mp['compute_mode']}): without it the ranks' kernels "
        f"are time-sliced on the card")
    for sync in ("staged", "fused"):
        v = mesh[sync]
        log(f"[14] {sync}: {v['seconds_per_iteration']:.4f} s/iteration "
            f"({[round(t, 4) for t in v['iterations']]}; phase 5: "
            f"{full['seconds_per_iteration']:.4f}, phase 13: "
            f"{shard[sync]['seconds_per_iteration']:.4f}), collectives an "
            f"iteration {v['collectives_per_iteration']}, over the chain "
            f"axis {v['collectives_chains_per_iteration']}, "
            f"{v['collective_host_seconds_per_iteration']:.4f} s of host "
            f"time a rank")
        log(f"[14] {sync} launches a rank in iteration 1: "
            f"{v['launches_per_rank']}")
        for c, ch in enumerate(v["chains"]):
            cm, rp = ch["vs_multichain"], ch["replay"]
            log(f"[14] {sync} chain {c}: p' {ch['p_prime']}, p′ rank's tail "
                f"device ms {[round(t, 2) for t in ch['tail_ms']]} "
                f"({mesh['N_p']} rows x L={mesh['L']}); first iteration vs "
                f"multichain at P={mesh['P']}: {cm['z_bits_differing']} Z "
                f"bits differ (shards {cm['shards_differing']}), A max "
                f"|diff| {cm.get('A_max_abs_diff', float('nan')):.3g}; "
                f"master replayed: A {rp['A_rel_max']:.3g} of max |A|, "
                f"sigma_x {rp['sigma_x_rel']:.3g}; K+ {ch['K']}, sigma_x "
                f"{ch['sigma_x']:.4f}")
    v = mesh["stale"]
    log(f"[14] stale pass: {v['seconds']:.4f} s, collectives "
        f"{v['collectives']}, tails' device ms {v['tail_ms']}; SSE identity "
        f"gaps {mesh['sse']}; one all-reduce over a data group (ms) "
        f"{mesh['all_reduce_ms']}")
    v = mesh["scan"]
    log(f"[14] collapsed_scan {v['shape']} against the plain scan: "
        f"{v['decisions_differing']} decisions differ, boundary event "
        f"{v['boundary_event']}, counts equal {v['counts_equal']}; alone: "
        f"ms={v['ms']:.3f} call_ms={v['call_ms']:.3f} ({v['timing']}) "
        f"ms/row={v['ms_per_row']:.5f} bound_ms={v['bound_ms']:.5f} "
        f"({v['bound_by']}) plain_ms={v['plain_ms']:.1f} (on "
        f"{v['plain_device']})")
    for name, v in mesh["kernels"].items():
        log(f"[14] {name} {v['shape']}: ms={v['ms']:.4f} "
            f"call_ms={v['call_ms']:.4f} bound_ms={v['bound_ms']:.5f} "
            f"({v['bound_by']}) plain_ms={v['plain_ms']:.4f} library_ms="
            f"{v['library_ms']} max_abs_err={v['max_abs_err']:.3g}")
    v = mesh["scorer"]
    log(f"[14] make_sharded_scorer, {v['ranks']} data ranks x {v['groups']} "
        f"groups on one card, {v['rows']} rows, S={v['S']}: "
        f"{v['rows_per_s']:.0f} rows/s a group ({v['seconds']:.4f} s), one "
        f"process {v['one_process_rows_per_s']:.0f} rows/s; max |diff| "
        f"from the one-process blocks {v['max_abs_diff']:.3g} (limit "
        f"{MESH['score_tol']})")
    v = mesh["mesh_vmap"]
    log(f"[14] chains=mesh x data=vmap, {mesh['C']} ranks at P={v['P']}: "
        f"{v['seconds_per_iteration']:.4f} s/iteration "
        f"({[round(t, 4) for t in v['iterations']]}; phase 12, "
        f"C={MULTI['C']} in one process: "
        f"{multi['drive']['seconds_per_iteration']:.4f}); vs multichain: "
        + "; ".join(f"chain {c} {ch['z_bits_differing']} Z bits, A "
                    f"{ch['A_rel_max']:.3g}, bitwise {ch['bitwise_equal']}, "
                    f"tail ms {[round(t, 2) for t in ch['tail_ms']]}"
                    for c, ch in enumerate(v["chains"])))
    v = mesh["nccl_one"]
    log(f"[14] driver=mesh, 1 chain x 1 shard in an NCCL world of one rank "
        f"({v['backend']}), {v['rows']} rows, {v['iters']} iterations, "
        f"{v['records']} evals and a checkpoint: bitwise equal to the "
        f"multichain driver at C=1 (state, eval records, checkpoint) "
        f"{v['bitwise_equal']}; collectives {v['collectives']}, over the "
        f"chain axis {v['collectives_chains']}; in the world of one rank "
        f"shared with phase 13, spawned and run in {v['spawn_seconds']:.1f} "
        f"s")
    log(f"[14] phase took {time.perf_counter() - t0:.1f} s")

    # phase 15: the LM substrate on the card
    t0 = time.perf_counter()
    lm, lm_counts = run_lm(dev, smi)
    for line in lm["cli"]:
        log(f"[15] CLI (repro_torch.launch.serve, {LM['arch']}, defaults): "
            f"{line}")
    v = lm["serve"]
    log(f"[15] serve {v['model']} ({v['layers']} layers, {v['dtype']}), "
        f"B={v['batch']}, prompt {v['prompt_len']}, {v['new']} new: "
        f"{v['tokens_per_s']:.1f} tok/s inc. prefill "
        f"({v['new_tokens_per_s']:.1f} new tok/s), wall {v['seconds']:.4f} s, "
        f"peak device memory {v['max_memory_allocated']} bytes "
        f"({v['memory_held_before']} held before the loop); the CLI's "
        f"first run took {lm['cli_seconds']:.2f} s; gpu: {smi}")
    v = lm["step_profile"]
    log(f"[15] one bf16 decode step of {v['model']} at B={v['batch']} "
        f"(median of {v['steps']}): wall {v['wall_ms_per_step']:.3f} ms, "
        f"{v['kernels_per_step']:.0f} device kernels taking "
        f"{v['device_ms_per_step']:.3f} ms, device busy "
        f"{v['busy_share']:.3f}")
    for m in lm["models"]:
        log(f"[15] {json.dumps(m)}")
        h, c, sv = m["decode_vs_forward"], m["card_vs_cpu"], m["serve"]
        log(f"[15] {m['model']} ({m['layers']} layers): decode vs forward "
            f"over {h['positions']} positions max |diff| "
            f"{h['max_abs_err']:.3g} (limit {h['limit']:.3g}), "
            f"{h['argmax_differing']} argmaxes differ, {h['near_ties']} "
            f"near ties (top two within {LM['tie_gap']}); card vs CPU at "
            f"{c['layers']} layers max |diff| {c['max_abs_err']:.3g} (limit "
            f"{c['limit']:.3g}); bf16 serve {sv['tokens_per_s']:.1f} tok/s "
            f"inc. prefill, {sv['ids_past_vocab']} ids past the vocab"
            + (f"; with random enc_out decode differs from the forward by "
               f"{h['random_enc_out_gap']:.3g} (cross-attention query at "
               f"position 0)" if "random_enc_out_gap" in h else ""))
        for key, form in (("step_profile", "gelu op by op"),
                          ("step_profile_fused_gelu", "one F.gelu")):
            if key in m:
                v = m[key]
                log(f"[15] one bf16 decode step of {m['model']} "
                    f"({m['layers']} layers, {form}) at B={v['batch']} "
                    f"(median of {v['steps']}): wall "
                    f"{v['wall_ms_per_step']:.3f} ms, "
                    f"{v['kernels_per_step']:.0f} device kernels taking "
                    f"{v['device_ms_per_step']:.3f} ms, device busy "
                    f"{v['busy_share']:.3f}")
    v = lm["compose"]
    log(f"[15d] IBP over {v['backbone']} logits: N={v['N']} D={v['D']} "
        f"(embedded in {v['embed_seconds']:.2f} s), P={v['P']} "
        f"K_max={v['K_max']} K_tail={v['K_tail']} L={v['L']}, {v['iters']} "
        f"iterations at {v['seconds_per_iteration']:.4f} s: K+ = "
        f"{v['K_plus']}, alpha = {v['alpha']:.3f}, sigma_x = "
        f"{v['sigma_x']:.4f}; launches {v['launches']}")
    log(f"[15] phase took {time.perf_counter() - t0:.1f} s")

    # phase 16: the LM's other temporal mixers
    t0 = time.perf_counter()
    reset_launch_counts()
    mixers = run_lm_mixers(dev, smi)
    mixer_counts = launch_counts()
    log_lm_mixers(mixers, smi)
    if any(mixer_counts.get(k, 0) for k in KERNELS):
        raise AssertionError(f"phase 16 launched a kernel: {mixer_counts}")
    log(f"[16] launches {mixer_counts}; phase took "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 17: LM training
    t0 = time.perf_counter()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmpdir:
        tr = run_train(Path(tmpdir), dev, smi)
    train_counts = launch_counts()
    log_train(tr, smi)
    if any(train_counts.get(k, 0) for k in KERNELS):
        raise AssertionError(f"phase 17 launched a kernel: {train_counts}")
    log(f"[17] launches {train_counts}; phase took "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 18: the LM on a mesh (its ranks' work done in phase 13's spawn)
    t0 = time.perf_counter()
    lm_mesh = check_lm_mesh(lm_ranks, lm_clock)
    log_lm_mesh(lm_mesh, smi)
    log(f"[18] phase took {time.perf_counter() - t0:.1f} s here")

    # phase 19: the dry run on the card
    t0 = time.perf_counter()
    reset_launch_counts()
    dry, dry_counts = run_dryrun(dev, lm_mesh)
    log_dryrun(dry, smi)
    log(f"[19] launches in the IBP cells {dry_counts}; phase took "
        f"{time.perf_counter() - t0:.1f} s")

    # phase 6: the main paths went through every kernel that carries them
    for tpu, name in CARRIED_BY.items():
        log(f"[6] {tpu} runs as {name} on the main path")
    for name in MAIN_PATH:
        if cli_counts.get(name, 0) < 1 or full_counts.get(name, 0) < 1:
            raise AssertionError(
                f"{name} was not launched on the main path (CLI "
                f"{cli_counts.get(name)}, full width "
                f"{full_counts.get(name)})")
    for name in COLLAPSED_PATH:
        if coll_counts.get(name, 0) < 1 or packed_counts.get(name, 0) < 1:
            raise AssertionError(
                f"{name} was not launched by the serial collapsed sampler "
                f"(phase 9 {coll_counts}, phase 10 {packed_counts})")
    for name in MAIN_PATH:
        if serving_counts.get(name, 0) < 1:
            raise AssertionError(
                f"{name} was not launched by phase 11's harvest and naive "
                f"scorer ({serving_counts})")
    for name in MAIN_PATH:
        if multi_counts.get(name, 0) < 1:
            raise AssertionError(
                f"{name} was not launched by phase 12's multichain run "
                f"({multi_counts})")
    for name in MAIN_PATH:
        if shard_counts.get(name, 0) < 1:
            raise AssertionError(
                f"{name} was not launched by phase 13's ranks "
                f"({shard_counts})")
    for name in MAIN_PATH:
        if mesh_counts.get(name, 0) < 1:
            raise AssertionError(
                f"{name} was not launched by phase 14's ranks "
                f"({mesh_counts})")
    for name in ("gibbs_flip", "collapsed_scan"):
        if lm_counts.get(name, 0) < 1:
            raise AssertionError(
                f"{name} was not launched by phase 15d's sampler "
                f"({lm_counts})")
    log(f"[6] {', '.join(MAIN_PATH)} launched in phases 4, 5, 11-14 "
        f"(gibbs_flip {serving['naive']['naive_gibbs_flip_launches']} "
        f"times by the naive scorer; collapsed_scan once a sub-iteration "
        f"for all {MULTI['C']} chains in phase 12); "
        f"{', '.join(COLLAPSED_PATH)} in phases 9 and 10; gibbs_flip and "
        f"collapsed_scan in phase 15d")

    later = {"gibbs_flip": [grown["gibbs_flip"], base_sweep,
                            *serving["gibbs_flip_naive"],
                            shard["kernels"]["gibbs_flip"],
                            mesh["kernels"]["gibbs_flip"],
                            dry["ibp"]["kernels"]["gibbs_flip"]],
             "collapsed_scan": [coll["scan_kernel"], coll["scan_prefix"],
                                *packed["holds"], *multi["holds"],
                                *multi["timing"], mesh["scan"],
                                dry["ibp"]["scan"]],
             "feature_stats": [grown["feature_stats"], *coll["stats"],
                               shard["kernels"]["feature_stats"],
                               mesh["kernels"]["feature_stats"],
                               dry["ibp"]["kernels"]["feature_stats"]],
             "gaussian_sse": [grown["gaussian_sse"],
                              shard["kernels"]["gaussian_sse"],
                              mesh["kernels"]["gaussian_sse"],
                              dry["ibp"]["kernels"]["gaussian_sse"]]}
    kernels = []
    for name in KERNELS:
        r = results[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=REPLACES[name], launches=full_counts.get(name, 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], call_ms=r["call_ms"],
            timing=r["timing"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            library_call_ms=r.get("library_call_ms"), shape=r["shape"],
            library_call=r["library_call"],
            **{k: r[k] for k in ("boundary_event", "n_refresh", "n_sat",
                                 "read_x_ms", "product_ms") if k in r},
            sass_hmma=sass.get(name),
            launches_cli=cli_counts.get(name, 0),
            launches_growth=growth_counts.get(name, 0),
            launches_baseline=base_counts.get(name, 0),
            launches_collapsed=coll_counts.get(name, 0),
            launches_packed=packed_counts.get(name, 0),
            launches_serving=serving_counts.get(name, 0),
            launches_multichain=multi_counts.get(name, 0),
            launches_stale=stale_counts.get(name, 0),
            launches_shardmap=shard_counts.get(name, 0),
            launches_mesh=mesh_counts.get(name, 0),
            launches_lm=lm_counts.get(name, 0),
            launches_lm_mixers=mixer_counts.get(name, 0),
            launches_lm_train=train_counts.get(name, 0),
            launches_dryrun=dry_counts.get(name, 0),
            on_main_path=name in MAIN_PATH,
            variants=r.get("variants", []) + later.get(name, [])))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "gpu": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
