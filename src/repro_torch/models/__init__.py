"""The LM substrate's models (ROADMAP item 11a-1: the attention families).

The counterpart of ``repro/models``; ``ActSpecs`` (activation sharding)
waits for ROADMAP item 11c.
"""
from .transformer import (
    init_caches,
    init_model,
    model_apply,
    pad_vocab,
)
from .lm import (
    cross_entropy,
    greedy_generate,
    lm_loss,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "init_caches",
    "init_model",
    "model_apply",
    "pad_vocab",
    "cross_entropy",
    "greedy_generate",
    "lm_loss",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
]
