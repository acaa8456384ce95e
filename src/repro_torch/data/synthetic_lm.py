"""Deterministic synthetic token pipeline for the LM substrate.

A cheap Zipf-ish Markov stream: reproducible across hosts (pure function of
(seed, step, shard)), infinite, no files — what the framework's data layer
feeds trainers in lieu of a tokenized corpus. Shard-aware: each data shard
draws a disjoint slice of the stream, the contract a real distributed loader
must satisfy.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_shards: int = 1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.n_shards = n_shards
        assert global_batch % n_shards == 0

    def batch(self, step: int, shard: int = 0) -> dict[str, np.ndarray]:
        b = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + shard
        )
        # Zipf marginals + short-range repetition structure (so loss can fall)
        ranks = rng.zipf(1.3, size=(b, self.seq_len)).astype(np.int64)
        toks = np.minimum(ranks, self.vocab - 1)
        # inject copy structure: second half repeats first half shifted
        half = self.seq_len // 2
        toks[:, half:half * 2] = toks[:, :half]
        return {"tokens": toks.astype(np.int32)}
