"""phi3.5-moe-42b-a6.6b [moe; hf:microsoft/Phi-3.5-MoE-instruct]: 32L, d=4096,
32H (kv=8), MoE 16 experts top-2, d_ff_expert=6400, vocab=32064."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32064,
        n_experts=16,
        n_shared_experts=0,
        top_k=2,
        d_ff_expert=6400,
        capacity_factor=1.25,
        norm="ln",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        n_experts=4,
        n_shared_experts=0,
        top_k=2,
        d_ff_expert=32,
        capacity_factor=1.25,
        norm="ln",
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
