"""Model composition: blocks, the layer stack, full-model init/apply.

The counterpart of ``repro/models/transformer.py``. Families
(``configs/base.py``):
  dense / vlm  — decoder-only: x += attn(n(x)); x += mlp(n(x))
  moe          — decoder-only with the routed-expert FFN (+ shared experts)
  ssm          — mamba blocks: x += ssm(n(x)), no FFN
  hybrid       — RecurrentGemma: superblocks of ``rglru_pattern`` (RG-LRU
                 or local attention, each + MLP), then the tail's blocks
  encdec       — whisper backbone: encoder (bidir) + decoder (causal + cross)
The reference scans stacked (L, ...) layer weights; here each layer is a
``Block`` (in ``layers``, or in the hybrid's ``superblocks`` and
``tail``), run in a Python loop in execution order, and the caches are
one a layer in that order. In training with ``cfg.remat`` each layer
(the hybrid's each superblock) is rematerialised, as the reference's
``jax.checkpoint`` over its scan body does.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch import device as _device

from . import attention as attn_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .modules import (activation, embed_init, init_weights, layer_norm,
                      linear_init, norm_init, rms_norm)


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
    """ln1 + the temporal mixer (``attn``: GQA or MLA; ``ssm``; ``rec``:
    RG-LRU) [+ lnx + cross-attention] + ln2 + the FFN (``moe`` when the
    config has experts, else ``mlp``). A mamba block (kind "ssm") has no
    ln2 and no FFN. ``window`` is the local attention window of an
    attention block (0: global)."""

    def __init__(self, cfg, kind: str, cross: bool = False, window: int = 0,
                 device=None):
        super().__init__()
        self.kind, self.window = kind, window
        self.ln1 = norm_init(cfg.d_model, device)
        if kind == "ssm":
            self.ssm = ssm_lib.SSM(cfg, device)
            return
        if kind == "rglru":
            self.rec = rglru_lib.RGLRU(cfg, device)
        else:
            attn_cls = attn_lib.MLA if kind == "mla" else attn_lib.GQA
            self.attn = attn_cls(cfg, device)
        if cross:
            self.lnx = norm_init(cfg.d_model, device)
            self.xattn = attn_lib.GQA(cfg, device)
        self.ln2 = norm_init(cfg.d_model, device)
        if cfg.n_experts:
            self.moe = moe_lib.MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


def _block_apply(p: Block, x, cfg, *, mode, positions, cache, enc_out=None):
    """Returns (x, the layer's new cache, its aux loss: None without
    experts)."""
    aux = None
    h = _norm(x, p.ln1, cfg)
    if p.kind == "ssm":
        y, new_cache = ssm_lib.ssm_apply(p.ssm, h, cfg, mode=mode,
                                         cache=cache)
        return x + y, new_cache, aux
    if p.kind == "rglru":
        y, new_cache = rglru_lib.rglru_apply(p.rec, h, cfg, mode=mode,
                                             cache=cache)
    elif p.kind == "mla":
        y, new_cache = attn_lib.mla_apply(p.attn, h, cfg, mode=mode,
                                          positions=positions, cache=cache)
    else:
        y, new_cache = attn_lib.gqa_apply(p.attn, h, cfg, mode=mode,
                                          positions=positions, cache=cache,
                                          window=p.window)
    x = x + y
    if enc_out is not None and hasattr(p, "xattn"):
        # positions=None: the query is roped at arange(S), so at 0 in
        # decode (the reference's behaviour, ROADMAP §3)
        hx = _norm(x, p.lnx, cfg)
        y, _ = attn_lib.gqa_apply(p.xattn, hx, cfg, mode="encode",
                                  kv_src=enc_out)
        x = x + y
    h2 = _norm(x, p.ln2, cfg)
    if hasattr(p, "moe"):
        y2, aux = moe_lib.moe_apply(p.moe, h2, cfg)
    else:
        y2 = mlp_apply(p.mlp, h2, cfg)
    return x + y2, new_cache, aux


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


def _hybrid_layout(cfg) -> tuple[tuple, int, int]:
    """The hybrid stack: (its pattern of block kinds, the number of
    superblocks, the number of tail blocks)."""
    pat = tuple("rglru" if k == "rec" else "attn"
                for k in (cfg.rglru_pattern or ("rec", "rec", "attn")))
    return pat, cfg.n_layers // len(pat), cfg.n_layers % len(pat)


def _layer_kinds(cfg) -> list[tuple[str, int]]:
    """(kind, window) of every decoder layer in execution order."""
    if cfg.family != "hybrid":
        return [(layer_kind(cfg), 0)] * cfg.n_layers
    pat, n_super, rest = _hybrid_layout(cfg)
    order = list(pat) * n_super + list(pat[:rest])
    return [(k, cfg.local_window if k == "attn" else 0) for k in order]


class LM(torch.nn.Module):
    """embed (Vp, d), final_ln, lm_head (d, Vp) unless tied, then the
    decoder: ``layers`` (a ModuleList of ``Block``), or for the hybrid
    family ``superblocks`` (a ModuleList of ModuleDicts of b0, b1, ...,
    one a position of the pattern) and ``tail`` (a ModuleDict of t0, t1,
    ...); encdec adds enc_embed (enc_seq, d), enc_layers and
    enc_final_ln. Parameter names follow the reference's param tree with
    the superblock or layer index in place of the stacked axis."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, Vp = cfg.d_model, pad_vocab(cfg.vocab)
        self.embed = embed_init(Vp, d, device)
        self.final_ln = norm_init(d, device)
        if not cfg.tie_embeddings:
            self.lm_head = linear_init(d, Vp, device)
        if cfg.family == "hybrid":
            pat, n_super, rest = _hybrid_layout(cfg)
            w = cfg.local_window

            def block(kind):
                return Block(cfg, kind, window=w if kind == "attn" else 0,
                             device=device)

            self.superblocks = torch.nn.ModuleList(
                torch.nn.ModuleDict({f"b{i}": block(k)
                                     for i, k in enumerate(pat)})
                for _ in range(n_super))
            self.tail = torch.nn.ModuleDict(
                {f"t{i}": block(pat[i]) for i in range(rest)})
        elif cfg.family == "encdec":
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
                Block(cfg, layer_kind(cfg), device=device)
                for _ in range(cfg.n_layers))

    def decoder_blocks(self) -> list[Block]:
        """The decoder's blocks in execution order (``init_caches``'s)."""
        return [b for unit, _ in self.decoder_units() for b in unit]

    def decoder_units(self) -> list[tuple[list[Block], bool]]:
        """The decoder's blocks in execution order, grouped as the
        reference rematerialises them: (blocks, rematerialisable), one
        layer a unit, or one superblock (its pattern's blocks) a unit
        and each tail block a unit of its own that is not
        rematerialised (the reference runs the tail outside its
        ``jax.checkpoint``)."""
        if hasattr(self, "superblocks"):
            return [(list(sb.values()), True) for sb in self.superblocks] \
                + [([b], False) for b in self.tail.values()]
        return [([b], True) for b in self.layers]


def init_model(gen: int | torch.Generator, cfg, *, device=None) -> LM:
    """A model of ``cfg`` with float32 weights drawn from ``gen`` (a seed,
    or a ``torch.Generator`` on ``device``) by the reference's
    initialisers. ``device`` defaults to ``cuda`` (``device.resolve``);
    ``"meta"`` builds the parameters' shapes and allocates nothing."""
    dev = torch.device("meta") if str(device) == "meta" else \
        _device.resolve(device)
    model = LM(cfg, dev)
    if dev.type != "meta":
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        init_weights(model, gen)
    return model


def _run_unit(blocks, x, cfg, *, mode, positions, caches, enc_out):
    aux, new_caches = None, []
    for i, block in enumerate(blocks):
        x, nc, aux_l = _block_apply(
            block, x, cfg, mode=mode, positions=positions,
            cache=None if caches is None else caches[i], enc_out=enc_out)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
        new_caches.append(nc)
    return x, new_caches, aux


def _run_stack(units, x, cfg, *, mode, positions, caches, enc_out=None,
               keep_aux=True):
    """The units (``LM.decoder_units``' form) in order; returns (x, the
    summed aux losses, zero unless ``keep_aux``, the new caches or None).
    In mode "train" with ``cfg.remat`` each rematerialisable unit runs
    under ``torch.utils.checkpoint``: its activations are recomputed in
    the backward pass, as the reference's ``jax.checkpoint`` recomputes
    them (the recompute is deterministic, so values and gradients are
    those of the run without it)."""
    remat = cfg.remat and mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches, at = [], 0
    for blocks, can_remat in units:
        cs = None if caches is None else caches[at:at + len(blocks)]
        at += len(blocks)
        run = functools.partial(_run_unit, blocks, cfg=cfg, mode=mode,
                                positions=positions, caches=cs,
                                enc_out=enc_out)
        if remat and can_remat:
            x, ncs, aux_u = torch.utils.checkpoint.checkpoint(
                run, x, use_reentrant=False)
        else:
            x, ncs, aux_u = run(x)
        if keep_aux and aux_u is not None:
            aux = aux + aux_u
        new_caches += ncs
    return x, aux, (new_caches if caches is not None else None)


def model_apply(model: LM, batch: dict, cfg, *, mode: str, caches=None):
    """Returns (logits float32 (B, S, Vp), aux_loss, new_caches). In decode
    the caches' tensors are written in place (``attention``, ``ssm``,
    ``rglru``)."""
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

    enc_out = None
    if cfg.family == "encdec":
        if "enc_out" in batch:  # serving: encoder ran once at prefill
            enc_out = batch["enc_out"].to(x.dtype)
        elif "frames" in batch:  # whisper's encoder: non-causal, "encode"
            e = batch["frames"].to(x.dtype) \
                + model.enc_embed[None].to(x.dtype)
            pos = torch.arange(e.shape[1], dtype=torch.int32,
                               device=e.device)[None]
            e, _, _ = _run_stack([([b], False) for b in model.enc_layers],
                                 e, cfg, mode="encode", positions=pos,
                                 caches=None)
            enc_out = _norm(e, model.enc_final_ln, cfg)
    # the hybrid's blocks drop their aux losses, as the reference's
    # _hybrid_apply does
    x, aux, new_caches = _run_stack(model.decoder_units(), x, cfg,
                                    mode=mode, positions=positions,
                                    caches=caches, enc_out=enc_out,
                                    keep_aux=cfg.family != "hybrid")

    x = _norm(x, model.final_ln, cfg)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = torch.matmul(x, head.to(x.dtype))
    return logits.float(), aux, new_caches


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def init_caches(cfg, B: int, S: int, device=None) -> list:
    """One cache a decoder layer in execution order: ``KVCache`` (GQA;
    a ring of ``local_window`` slots for the hybrid's local attention when
    S reaches it; MLA: the latent and rope caches), ``SSMCache`` or
    ``RGLRUCache``, each with its own int32 length."""
    dtype = _compute_dtype(cfg)

    def make(kind: str, window: int):
        if kind == "ssm":
            return ssm_lib.init_ssm_cache(cfg, B, dtype, device)
        if kind == "rglru":
            return rglru_lib.init_rglru_cache(cfg, B, dtype, device)
        if kind == "mla":
            return attn_lib.init_mla_cache(cfg, B, S, dtype, device)
        return attn_lib.init_gqa_cache(cfg, B, S, dtype, device,
                                       window=window)

    return [make(kind, window) for kind, window in _layer_kinds(cfg)]


def _cache_length(caches, cfg) -> torch.Tensor:
    """The shared scalar length: the first int32 leaf of the caches (the
    first layer's; every layer advances together)."""
    for c in caches:
        for leaf in c:
            if leaf.dtype == torch.int32:
                return leaf.reshape(-1)[0]
    return torch.zeros((), dtype=torch.int32)
