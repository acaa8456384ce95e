"""recurrentgemma-2b [hybrid; arXiv:2402.19427]: 26L, d=2560, 10H MQA (kv=1,
hd=256), d_ff=7680, vocab=256000. RG-LRU + local attention in 1:2 pattern
(rec, rec, attn), local window 2048, d_rnn=2560. long_500k RUNS (local attn
+ O(1) recurrent state)."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        rglru_pattern=("rec", "rec", "attn"),
        local_window=2048,
        d_rnn=2560,
        ssm_conv=4,
        act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        n_layers=5,  # (rec, rec, attn) + 2 tail rec
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        rglru_pattern=("rec", "rec", "attn"),
        local_window=8,
        d_rnn=64,
        ssm_conv=4,
        act="gelu",
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
