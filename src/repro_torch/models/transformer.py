"""Model composition: blocks, the layer stack, full-model init/apply.

The counterpart of ``repro/models/transformer.py`` for the families whose
temporal mixer is attention:
  dense / vlm  — decoder-only: x += attn(n(x)); x += mlp(n(x))
  encdec       — whisper backbone: encoder (bidir) + decoder (causal + cross)
with GQA or MLA attention. The reference scans stacked (L, ...) layer
weights; here each layer is a ``Block`` in an ``nn.ModuleList``, run in a
Python loop. ``moe``, ``ssm`` and ``hybrid`` (and any config with
experts) are refused by ``init_model`` until ROADMAP item 11a-2 ports them.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device

from . import attention as attn_lib
from .modules import (activation, embed_init, init_weights, layer_norm,
                      linear_init, norm_init, rms_norm)

UNPORTED_FAMILIES = ("moe", "ssm", "hybrid")


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


def _norm(x, scale, cfg, bias=None):
    if cfg.norm == "ln":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


def _compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------------
# sub-layers
# --------------------------------------------------------------------------


class MLP(torch.nn.Module):
    """wi (d, 2 d_ff) gated (gate, then up) or (d, d_ff); wo (d_ff, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        width = 2 * ff if cfg.gated_mlp else ff
        self.wi = linear_init(d, width, device)
        self.wo = linear_init(ff, d, device)


def mlp_apply(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    # the MLP casts its weights to the activation dtype (the attention
    # projections promote instead)
    h = torch.matmul(x, p.wi.to(x.dtype))
    if cfg.gated_mlp:
        g, u = h.chunk(2, dim=-1)
        h = activation(g, cfg.act) * u
    else:
        h = activation(h, cfg.act)
    return torch.matmul(h, p.wo.to(x.dtype))


class Block(torch.nn.Module):
    """ln1 + attention (GQA or MLA) [+ lnx + cross-attention] + ln2 + MLP."""

    def __init__(self, cfg, kind: str, cross: bool = False, device=None):
        super().__init__()
        self.kind = kind
        self.ln1 = norm_init(cfg.d_model, device)
        attn_cls = attn_lib.MLA if kind == "mla" else attn_lib.GQA
        self.attn = attn_cls(cfg, device)
        if cross:
            self.lnx = norm_init(cfg.d_model, device)
            self.xattn = attn_lib.GQA(cfg, device)
        self.ln2 = norm_init(cfg.d_model, device)
        self.mlp = MLP(cfg, device)


def _block_apply(p: Block, x, cfg, *, mode, positions, cache, window=0,
                 enc_out=None):
    h = _norm(x, p.ln1, cfg)
    if p.kind == "mla":
        y, new_cache = attn_lib.mla_apply(p.attn, h, cfg, mode=mode,
                                          positions=positions, cache=cache)
    else:
        y, new_cache = attn_lib.gqa_apply(p.attn, h, cfg, mode=mode,
                                          positions=positions, cache=cache,
                                          window=window)
    x = x + y
    if enc_out is not None and hasattr(p, "xattn"):
        # positions=None: the query is roped at arange(S), so at 0 in
        # decode (the reference's behaviour, ROADMAP §3)
        hx = _norm(x, p.lnx, cfg)
        y, _ = attn_lib.gqa_apply(p.xattn, hx, cfg, mode="encode",
                                  kv_src=enc_out)
        x = x + y
    h2 = _norm(x, p.ln2, cfg)
    return x + mlp_apply(p.mlp, h2, cfg), new_cache


# --------------------------------------------------------------------------
# full models
# --------------------------------------------------------------------------


def layer_kind(cfg) -> str:
    """Temporal-mixer kind; the FFN flavor (dense vs MoE) follows
    cfg.n_experts."""
    if cfg.family == "ssm":
        return "ssm"
    if cfg.attn == "mla":
        return "mla"
    return "attn"


def check_ported(cfg) -> None:
    """Refuse the families the port does not have yet."""
    if cfg.family in UNPORTED_FAMILIES or cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (n_experts={cfg.n_experts}) "
            f"is not ported yet; the port has the dense, vlm and encdec "
            f"families (GQA and MLA attention). moe, ssm, rglru and the "
            f"hybrid stack are ROADMAP item 11a-2")


class LM(torch.nn.Module):
    """embed (Vp, d), final_ln, lm_head (d, Vp) unless tied; layers (a
    ModuleList of ``Block``); encdec adds enc_embed (enc_seq, d),
    enc_layers and enc_final_ln. Parameter names follow the reference's
    param tree with the layer index in place of the stacked axis."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_ported(cfg)
        d, Vp = cfg.d_model, pad_vocab(cfg.vocab)
        self.embed = embed_init(Vp, d, device)
        self.final_ln = norm_init(d, device)
        if not cfg.tie_embeddings:
            self.lm_head = linear_init(d, Vp, device)
        kind = layer_kind(cfg)
        if cfg.family == "encdec":
            self.enc_embed = embed_init(cfg.enc_seq, d, device)
            self.enc_layers = torch.nn.ModuleList(
                Block(cfg, "attn", device=device)
                for _ in range(cfg.n_enc_layers))
            self.layers = torch.nn.ModuleList(
                Block(cfg, "attn", cross=True, device=device)
                for _ in range(cfg.n_layers))
            self.enc_final_ln = norm_init(d, device)
        else:
            self.layers = torch.nn.ModuleList(
                Block(cfg, kind, device=device) for _ in range(cfg.n_layers))


def init_model(gen: int | torch.Generator, cfg, *, device=None) -> LM:
    """A model of ``cfg`` with float32 weights drawn from ``gen`` (a seed,
    or a ``torch.Generator`` on ``device``) by the reference's
    initialisers. ``device`` defaults to ``cuda`` (``device.resolve``);
    ``"meta"`` builds the parameters' shapes and allocates nothing.
    Raises ``NotImplementedError`` for the families of ROADMAP item
    11a-2."""
    check_ported(cfg)
    dev = torch.device("meta") if str(device) == "meta" else \
        _device.resolve(device)
    model = LM(cfg, dev)
    if dev.type != "meta":
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        init_weights(model, gen)
    return model


def _run_stack(layers, x, cfg, *, mode, positions, caches, enc_out=None):
    new_caches = []
    for i, layer in enumerate(layers):
        x, nc = _block_apply(layer, x, cfg, mode=mode, positions=positions,
                             cache=None if caches is None else caches[i],
                             enc_out=enc_out)
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


def model_apply(model: LM, batch: dict, cfg, *, mode: str, caches=None):
    """Returns (logits float32 (B, S, Vp), aux_loss, new_caches). In decode
    the caches' tensors are written in place (``attention`` module)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = model.embed[tokens].to(_compute_dtype(cfg))

    if cfg.family == "vlm" and "patches" in batch and mode != "decode":
        pe = batch["patches"].to(x.dtype)  # (B, Pimg, d) vision stub
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)

    if mode == "decode":
        positions = _cache_length(caches, cfg).reshape(1, 1).expand(B, 1) \
            .to(torch.int32)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    enc_out = None
    if cfg.family == "encdec":
        if "enc_out" in batch:  # serving: encoder ran once at prefill
            enc_out = batch["enc_out"].to(x.dtype)
        elif "frames" in batch:  # whisper's encoder: non-causal, "encode"
            e = batch["frames"].to(x.dtype) \
                + model.enc_embed[None].to(x.dtype)
            pos = torch.arange(e.shape[1], dtype=torch.int32,
                               device=e.device)[None]
            e, _ = _run_stack(model.enc_layers, e, cfg, mode="encode",
                              positions=pos, caches=None)
            enc_out = _norm(e, model.enc_final_ln, cfg)
    x, new_caches = _run_stack(model.layers, x, cfg, mode=mode,
                               positions=positions, caches=caches,
                               enc_out=enc_out)

    x = _norm(x, model.final_ln, cfg)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = torch.matmul(x, head.to(x.dtype))
    return logits.float(), aux, new_caches


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def init_caches(cfg, B: int, S: int, device=None) -> list:
    """One ``KVCache`` a decoder layer (MLA: the latent and rope caches)."""
    check_ported(cfg)
    dtype = _compute_dtype(cfg)
    if layer_kind(cfg) == "mla":
        return [attn_lib.init_mla_cache(cfg, B, S, dtype, device)
                for _ in range(cfg.n_layers)]
    return [attn_lib.init_gqa_cache(cfg, B, S, dtype, device)
            for _ in range(cfg.n_layers)]


def _cache_length(caches, cfg) -> torch.Tensor:
    """The shared scalar length: the first int32 leaf of the caches."""
    for c in caches:
        for leaf in c:
            if leaf.dtype == torch.int32:
                return leaf.reshape(-1)[0]
    return torch.zeros((), dtype=torch.int32)
