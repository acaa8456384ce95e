"""Architecture + run configuration dataclasses.

One ``ModelConfig`` covers all 10 assigned families via optional blocks
(attention flavor, MoE, SSM, RG-LRU hybrid, encoder-decoder, modality stub).
Exact per-arch instances live in src/repro_torch/configs/<id>.py; every
file also exposes ``smoke()`` — a reduced same-family config for CPU tests.
The values are the reference package's, field by field (``micro_batches``
and the other execution fields were sized there for 16 GB TPU chips; the
port keeps them so the two packages name the same configurations).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

AttnKind = Literal["gqa", "mla", "none", "local"]
FamilyKind = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: FamilyKind
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    attn: AttnKind = "gqa"
    norm: Literal["rms", "ln"] = "rms"
    act: Literal["silu", "gelu"] = "silu"
    gated_mlp: bool = True
    learned_pos: bool = False            # whisper-style learned pos-embeds
    tie_embeddings: bool = False
    rope_theta: float = 10000.0

    # --- MLA (minicpm3, deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 0                 # 0 -> head_dim

    # --- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "a2a"                # "a2a" (all-to-all expert-parallel
                                         # dispatch) | "gather" (global-
                                         # capacity baseline)

    # --- SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                 # 0 -> ceil(d_model / 16)

    # --- hybrid (recurrentgemma): pattern of temporal blocks, period 3
    rglru_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    local_window: int = 0                # local attention window (hybrid/"local")
    d_rnn: int = 0                       # RG-LRU width (0 -> d_model)

    # --- encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                     # encoder frames (audio stub length)

    # --- modality stub (whisper audio frontend / internvl vision frontend)
    stub_tokens: int = 0                 # patch/frame embeddings provided as input

    # --- execution
    dtype: str = "bfloat16"
    remat: bool = True
    micro_batches: int = 1               # gradient-accumulation slices per
                                         # train step (activation mem ~1/k)
    unroll_layers: bool = False          # unroll scan-over-layers (probes: XLA
                                         # cost_analysis counts a scan body once)
    attn_chunk: int = 1024               # flash-style kv-chunk size
    scan_chunk: int = 128                # ssm/rglru sequence chunk
    logit_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once if tied)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        n = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            di = self.d_inner
            per_layer = d * 2 * di + di * self.ssm_conv + \
                di * (self.dt_rank + 2 * self.ssm_state) + self.dt_rank * di + \
                di * self.ssm_state + di + di * d + d
        else:
            if self.attn == "mla":
                qdim = (self.qk_nope_dim or hd) + self.qk_rope_dim
                q_in = self.q_lora_rank or d
                attn_p = (d * self.q_lora_rank if self.q_lora_rank else 0)
                attn_p += q_in * self.n_heads * qdim
                attn_p += d * (self.kv_lora_rank + self.qk_rope_dim)
                attn_p += self.kv_lora_rank * self.n_heads * ((self.qk_nope_dim or hd) + hd)
                attn_p += self.n_heads * hd * d
            else:
                attn_p = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            mlp_p = 3 * d * ff
            if self.n_experts:
                e_ff = self.d_ff_expert or ff
                mlp_p = d * self.n_experts \
                    + self.n_experts * 3 * d * e_ff \
                    + self.n_shared_experts * 3 * d * e_ff
            per_layer = attn_p + mlp_p + 2 * d
        n += L * per_layer
        if self.family == "hybrid":
            # rough: recurrent blocks ~ attn-sized temporal mixers
            pass
        if self.n_enc_layers:
            n += self.n_enc_layers * (4 * d * d + 3 * d * ff + 2 * d)
            # decoder cross-attention
            n += L * (4 * d * d + d)
        return int(n)

    def param_count_active(self) -> int:
        """Params touched per token (MoE: top_k routed + shared experts)."""
        if not self.n_experts:
            return self.param_count()
        import dataclasses

        dense_like = dataclasses.replace(
            self,
            n_experts=self.top_k,
            capacity_factor=self.capacity_factor,
        )
        # router still sees all E experts
        return dense_like.param_count() + self.n_layers * self.d_model * (
            self.n_experts - self.top_k
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

# archs whose attention is sub-quadratic in cached length -> long_500k runs
SUBQUADRATIC = {"falcon-mamba-7b", "recurrentgemma-2b"}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, "pure full-attention arch: 512k decode cache is out of scope (DESIGN.md §5)"
    return True, ""
