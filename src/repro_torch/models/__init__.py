"""The LM substrate's models: the attention families (ROADMAP item
11a-1), the other temporal mixers, MoE, mamba-1 SSM, RG-LRU and the
hybrid stack (item 11a-2), their training step (item 11b), and their
runs on a mesh of ranks (item 11c-1: ``ActSpecs``, each parameter's
declared spec, ``param_specs``).

The counterpart of ``repro/models``.
"""
from .transformer import (
    ActSpecs,
    init_caches,
    init_model,
    layer_kind,
    model_apply,
    pad_vocab,
    param_specs,
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
    "ActSpecs",
    "init_caches",
    "init_model",
    "layer_kind",
    "model_apply",
    "pad_vocab",
    "param_specs",
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
