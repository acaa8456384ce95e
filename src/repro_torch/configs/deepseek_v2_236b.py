"""deepseek-v2-236b [moe MLA; arXiv:2405.04434]: 60L, d=5120, 128H (kv=128),
MoE 160 routed (top-6, d_ff_expert=1536) + 2 shared, dense d_ff for param
accounting 1536-granular; vocab=102400. MLA kv_lora=512, q_lora=1536, rope 64,
nope 128, v head 128."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        attn="mla",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,           # dense first-layer-style ffn unused; experts rule
        vocab=102400,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_dim=64,
        qk_nope_dim=128,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1536,
        capacity_factor=1.25,
        micro_batches=4,     # 60L x d=5120 + (E,C,d) dispatch buffers exceed
                             # the reference's 16 GB chips at full batch; grad-accumulate
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        family="moe",
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
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        d_ff_expert=32,
        capacity_factor=1.25,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
