"""minicpm3-4b [dense MLA; hf:openbmb/MiniCPM3-4B]: 62L, d=2560, 40H (kv=40),
d_ff=6400, vocab=73448. MLA: kv_lora=256, q_lora=768, qk rope/nope 32/64,
head 64 (HF config values)."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        attn="mla",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=6400,
        vocab=73448,
        kv_lora_rank=256,
        q_lora_rank=768,
        qk_rope_dim=32,
        qk_nope_dim=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke",
        family="dense",
        attn="mla",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        kv_lora_rank=16,
        q_lora_rank=32,
        qk_rope_dim=8,
        qk_nope_dim=16,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
