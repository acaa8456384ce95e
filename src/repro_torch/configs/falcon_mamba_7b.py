"""falcon-mamba-7b [ssm; arXiv:2410.05355]: 64L mamba1 blocks, d=4096
(d_inner=8192), ssm_state=16, vocab=65024. Attention-free — long_500k RUNS."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=65024,
        ssm_state=16,
        micro_batches=2,     # d_inner=8192 scan states at full batch
                             # slightly exceed the reference's 16 GB chips; 2 slices
        ssm_conv=4,
        ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=512,
        ssm_state=4,
        ssm_conv=4,
        ssm_expand=2,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
