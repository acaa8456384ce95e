"""granite-3-8b [dense GQA; hf:ibm-granite]: 40L, d=4096, 32H (kv=8),
d_ff=12800, vocab=49155."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab=49155,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
