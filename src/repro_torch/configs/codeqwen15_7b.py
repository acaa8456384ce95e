"""codeqwen1.5-7b [dense; hf:Qwen/CodeQwen1.5-7B]: 32L, d=4096, 32H (kv=32 =>
full MHA), d_ff=13440, vocab=92416. qwen1.5 arch (untied embeddings, SwiGLU)."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab=92416,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab=512,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
