"""The LM substrate's models: the attention families (ROADMAP item
11a-1), the other temporal mixers, MoE, mamba-1 SSM, RG-LRU and the
hybrid stack (item 11a-2), and their training step (item 11b).

The counterpart of ``repro/models``; ``ActSpecs`` (activation sharding)
waits for ROADMAP item 11c.
"""
from .transformer import (
    init_caches,
    init_model,
    layer_kind,
    model_apply,
    pad_vocab,
)
from .lm import (
    cross_entropy,
    greedy_generate,
    lm_loss,
    loss_and_grads,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from .moe import moe_apply
from .rglru import RGLRUCache, rglru_apply
from .ssm import SSMCache, ssm_apply

__all__ = [
    "init_caches",
    "init_model",
    "layer_kind",
    "model_apply",
    "pad_vocab",
    "cross_entropy",
    "greedy_generate",
    "lm_loss",
    "loss_and_grads",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "moe_apply",
    "RGLRUCache",
    "rglru_apply",
    "SSMCache",
    "ssm_apply",
]
