"""whisper-large-v3 [audio; arXiv:2212.04356]: enc-dec, 32L dec / 32L enc,
d=1280, 20H MHA (kv=20), d_ff=5120, vocab=51866. Conv frontend is a STUB —
input_specs provide precomputed frame embeddings (B, 1500, d)."""
from .base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,
        n_enc_layers=32,
        enc_seq=1500,
        micro_batches=8,     # enc-dec dual-stack activations at B=256 blow
                             # the reference's 16 GB chips; grad-accumulate 8
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        norm="ln",
        act="gelu",
        gated_mlp=False,
        stub_tokens=1500,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=16,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        norm="ln",
        act="gelu",
        gated_mlp=False,
        stub_tokens=16,
        dtype="float32",
        attn_chunk=16,
        scan_chunk=8,
    )
