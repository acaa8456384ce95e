"""internvl2-76b [vlm; arXiv:2404.16821]: InternViT (STUB: input_specs supply
precomputed patch embeddings) + LLaMA-3-70B-style backbone: 80L, d=8192, 64H
(kv=8), d_ff=28672, vocab=128256."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        rope_theta=500000.0,
        stub_tokens=256,     # ViT patch embeddings per image (stubbed)
        micro_batches=4,     # 80L x d=8192 train activations exceed
                             # the reference's 16 GB chips; grad-accumulate 4
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        stub_tokens=4,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
