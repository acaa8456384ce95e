"""smollm-135m [dense; hf:HuggingFaceTB/SmolLM-135M]: 30L, d=576, 9H (kv=3),
d_ff=1536, vocab=49152. llama-arch small; tied embeddings. Also the ~100M
end-to-end training example arch."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab=49152,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_ff=128,
        vocab=512,
        tie_embeddings=True,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
