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

On a mesh (``ActSpecs.mesh``, a ``parallel.Mesh``; the model placed by
``parallel.shard_model``) every rank runs the same program on its slice:
the batch is split as ``hid``'s first entry says and, in training with
sequence parallelism, the residual stream's sequence over tp. Norms, the
MLP, the MoE and the loss run on the rank's block of tokens (the
reference's ZeRO-3 MLP schedule, whatever its ``mlp_dp`` choice); a
mixer gathers the sequence it needs. Every weight is all-gathered from its
slices where a unit (a layer, a superblock) uses it, inside the unit's
rematerialisation, and its gradient reduce-scattered back; the two
schedules the reference writes out by hand stay tp-local: the a2a MoE's
expert slabs and the rows of the out-projection ``sp_out_proj`` reduces.
Megatron tensor-parallel compute (head-local attention) is not done.
"""
from __future__ import annotations

import copy
import functools
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.parallel import group as _group

from repro_torch import device as _device

from . import attention as attn_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .modules import (FSDP, TP, P, _param, activation, embed_init,
                      full_dim, init_weights, layer_norm, linear_init,
                      maybe_shard, norm_init, rms_norm)


class ActSpecs(NamedTuple):
    """The residual stream's sharding spec (resolved mesh axes) and the
    mesh: ``mesh``/``dp``/``tp`` are set when a mesh is known; with a
    ``parallel.Mesh`` the model runs on it. The reference's other
    layouts (its Megatron ``feat``, ``exp``, ``logits``) and its MLP
    schedule choice ``mlp_dp`` are not taken by the port's schedule:
    ``parallel.mesh.reference_layouts`` resolves them."""

    hid: Any = P()     # (B, S, d)   — d replicated
    mesh: Any = None   # parallel.Mesh, or a shape-only mesh
    dp: Any = None     # data-parallel axis name(s), e.g. ('pod', 'data')
    tp: Any = None     # tensor/expert-parallel axis name, e.g. 'model'


def stream_specs(specs: ActSpecs, shape) -> ActSpecs:
    """``specs`` with ``hid`` fitted to a stream of the full ``shape``
    (B, S, d): an entry whose axes do not divide its dim falls back to
    None, as the reference's ``maybe_shard`` does."""
    if specs.mesh is None:
        return specs
    return specs._replace(hid=P(*_group.fit_spec(specs.hid, shape,
                                                 specs.mesh)))


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
        self.wo = linear_init(ff, d, device, (TP, FSDP))


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


def _block_apply(p: Block, x, cfg, specs: ActSpecs = ActSpecs(), *, mode,
                 positions, cache, enc_out=None):
    """Returns (x, the layer's new cache, its aux loss: None without
    experts). On a mesh x is the rank's block in ``specs.hid``; the MLP
    and the norms run on it."""
    aux = None
    h = _norm(x, p.ln1, cfg)
    if p.kind == "ssm":
        y, new_cache = ssm_lib.ssm_apply(p.ssm, h, cfg, mode=mode,
                                         cache=cache, specs=specs)
        return x + y, new_cache, aux
    if p.kind == "rglru":
        y, new_cache = rglru_lib.rglru_apply(p.rec, h, cfg, mode=mode,
                                             cache=cache, specs=specs)
    elif p.kind == "mla":
        y, new_cache = attn_lib.mla_apply(p.attn, h, cfg, mode=mode,
                                          positions=positions, cache=cache,
                                          specs=specs)
    else:
        y, new_cache = attn_lib.gqa_apply(
            p.attn, h, cfg, mode=mode, positions=positions, cache=cache,
            window=p.window, specs=specs)
    x = x + y
    if enc_out is not None and hasattr(p, "xattn"):
        # positions=None: the query is roped at arange(S), so at 0 in
        # decode (the reference's behaviour, ROADMAP §3)
        hx = _norm(x, p.lnx, cfg)
        y, _ = attn_lib.gqa_apply(p.xattn, hx, cfg, mode="encode",
                                  kv_src=enc_out, specs=specs)
        x = x + y
    h2 = _norm(x, p.ln2, cfg)
    if hasattr(p, "moe"):
        y2, aux = moe_lib.moe_apply(p.moe, h2, cfg, specs=specs)
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
            self.enc_embed = _param((cfg.enc_seq, d), device)
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


def param_specs(model) -> dict:
    """{parameter name: the partition spec its init declared}, with the
    ``FSDP``/``TP`` placeholders (``parallel.mesh.resolve_param_specs``
    resolves them): the reference's ``init_model`` spec tree, one entry
    a parameter, a stacked leaf's spec without its stack axis.
    ``model``: an ``LM`` as ``init_model`` built it, or a config (its
    model built on the meta device)."""
    if not isinstance(model, torch.nn.Module):
        model = LM(model, torch.device("meta"))
    out = {}
    for name, p in model.named_parameters():
        spec = getattr(p, "pspec", None)
        if spec is None:
            raise ValueError(f"param_specs: {name} declares no spec (a "
                             f"deepcopy of a model drops them; pass the "
                             f"config)")
        out[name] = spec
    return out


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


def _cache_whole(cache, spec, specs: ActSpecs):
    """A layer's cache stored as ``spec`` says, gathered to the layout
    its step computes in: the rank's batch block of every leaf (the
    stream's batch entry), each other dim whole."""
    mesh = specs.mesh
    return type(cache)(*(
        maybe_shard(t, P(specs.hid[0]) if t.dim() else P(), mesh, s)
        for t, s in zip(cache, spec)))


def _cache_store(cache, new, spec, specs: ActSpecs):
    """The step's new cache written back as ``spec`` stores it: each
    stored leaf's slice copied into it in place; a new scalar (the
    length) taken as it is."""
    mesh, out = specs.mesh, []
    for t, n, s in zip(cache, new, spec):
        n = maybe_shard(n, s, mesh, P(specs.hid[0]) if n.dim() else P())
        if n.dim() and n is not t:
            t.copy_(n)
            n = t
        out.append(n)
    return type(cache)(*out)


def _run_unit(blocks, x, cfg, specs, *, mode, positions, caches, enc_out,
              cache_specs, whole):
    if whole is not None:
        blocks = whole(blocks, specs, mode,
                       full_dim(x.shape[1], specs.hid[1], specs.mesh))
    aux, new_caches = None, []
    for i, block in enumerate(blocks):
        c = None if caches is None else caches[i]
        if c is not None and specs.mesh is not None:
            c_in = _cache_whole(c, cache_specs[i], specs)
        else:
            c_in = c
        x, nc, aux_l = _block_apply(
            block, x, cfg, specs, mode=mode, positions=positions,
            cache=c_in, enc_out=enc_out)
        if c is not None and specs.mesh is not None:
            nc = _cache_store(c, nc, cache_specs[i], specs)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
        new_caches.append(nc)
    return x, new_caches, aux


def _run_stack(units, x, cfg, specs=ActSpecs(), *, mode, positions, caches,
               enc_out=None, keep_aux=True, cache_specs=None, whole=None):
    """The units (``LM.decoder_units``' form) in order; returns (x, the
    summed aux losses, zero unless ``keep_aux``, the new caches or None).
    In mode "train" with ``cfg.remat`` each rematerialisable unit runs
    under ``torch.utils.checkpoint``: its activations are recomputed in
    the backward pass, as the reference's ``jax.checkpoint`` recomputes
    them (the recompute is deterministic, so values and gradients are
    those of the run without it). On a mesh ``whole`` gathers a unit's
    weights inside it, so the recompute gathers them again."""
    remat = cfg.remat and mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches, at = [], 0
    for blocks, can_remat in units:
        cs = None if caches is None else caches[at:at + len(blocks)]
        css = None if cache_specs is None else \
            cache_specs[at:at + len(blocks)]
        at += len(blocks)
        run = functools.partial(_run_unit, blocks, cfg=cfg, specs=specs,
                                mode=mode, positions=positions, caches=cs,
                                enc_out=enc_out, cache_specs=css,
                                whole=whole)
        if remat and can_remat:
            x, ncs, aux_u = torch.utils.checkpoint.checkpoint(
                run, x, use_reentrant=False)
        else:
            x, ncs, aux_u = run(x)
        if keep_aux and aux_u is not None:
            aux = aux + aux_u
        new_caches += ncs
    return x, aux, (new_caches if caches is not None else None)


def _tp_local(block: Block, cfg, specs: ActSpecs, mode: str, S: int
              ) -> set[str]:
    """The parameters of ``block`` its step uses as tp chunks, not
    whole: the a2a MoE's expert slabs, the rows of the out-projection
    that ``sp_out_proj`` reduces over the sequence."""
    keep = set()
    if hasattr(block, "moe") and moe_lib._a2a_applicable(cfg, specs, S):
        keep |= {"moe.wi", "moe.wo"}
    if block.kind in ("attn", "mla") and mode == "train" \
            and specs.hid[1] is not None:
        keep.add("attn.wo")
    return keep


def _gatherer(model: LM, cfg, mesh):
    """On a mesh, the function that gives a unit's blocks whole for a
    stream (its specs, mode and full sequence length S): copies of them
    whose parameters are all-gathered from this rank's slices
    (``model.mesh_layout``), one all-gather an axis for the unit,
    differentiable, the tp-local ones (``_tp_local``) gathered over their
    other axes only."""
    layout = model.mesh_layout
    names = {id(t): n for n, t in model.named_parameters()}

    def whole(blocks, specs, mode, S):
        ts, sps = [], []
        for b in blocks:
            keep = _tp_local(b, cfg, specs, mode, S)
            for local, t in b.named_parameters():
                spec = layout[names[id(t)]].spec
                if local in keep:
                    spec = tuple(None if e == specs.tp else e for e in spec)
                ts.append(t)
                sps.append(spec)
        got = _group.gather_tensors(ts, sps, mesh)
        return copy.deepcopy(list(blocks),
                             {id(t): g for t, g in zip(ts, got)})

    return whole


def model_apply(model: LM, batch: dict, cfg, *, mode: str,
                specs: ActSpecs = ActSpecs(), caches=None, cache_specs=None):
    """Returns (logits float32 (B, S, Vp), aux_loss, new_caches). In decode
    the caches' tensors are written in place (``attention``, ``ssm``,
    ``rglru``).

    On a mesh (``specs.mesh``, the model sharded by
    ``parallel.shard_model``) ``batch`` is the whole batch on every rank;
    each rank takes its batch block (``hid``'s first entry), and the
    logits returned are its block of the residual stream's layout
    (``stream_specs(specs, (B, S, d)).hid``). ``caches`` are stored as
    ``cache_specs`` (``parallel.mesh.layer_cache_specs``) says; the aux
    loss is the whole batch's on every rank."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    mesh, specs0 = specs.mesh, specs
    whole, bdim = None, P()
    if mesh is not None:
        specs = stream_specs(specs, (B, S, cfg.d_model))
        bdim = P(specs.hid[0])
        batch = {k: maybe_shard(v, bdim, mesh) for k, v in batch.items()}
        tokens = batch["tokens"]
        whole = _gatherer(model, cfg, mesh)
        layout = model.mesh_layout
        top = [n for n in ("embed", "lm_head", "final_ln", "enc_embed",
                           "enc_final_ln") if n in layout]
        tops = dict(zip(top, _group.gather_tensors(
            [getattr(model, n) for n in top],
            [layout[n].spec for n in top], mesh)))
        weight = tops.__getitem__
    else:
        def weight(name):
            return getattr(model, name)
    embed = weight("embed")
    x = embed[tokens].to(_compute_dtype(cfg))

    if cfg.family == "vlm" and "patches" in batch and mode != "decode":
        pe = batch["patches"].to(x.dtype)  # (B, Pimg, d) vision stub
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    if mesh is not None:
        x = maybe_shard(x, specs.hid, mesh, bdim)

    if mode == "decode":
        positions = _cache_length(caches, cfg).reshape(1, 1).expand(
            tokens.shape[0], 1).to(torch.int32)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :]

    enc_out = None
    if cfg.family == "encdec":
        if "enc_out" in batch:  # serving: encoder ran once at prefill
            enc_out = batch["enc_out"].to(x.dtype)
        elif "frames" in batch:  # whisper's encoder: non-causal, "encode"
            e = batch["frames"].to(x.dtype) \
                + weight("enc_embed")[None].to(x.dtype)
            enc_specs = stream_specs(specs0, (B, *e.shape[1:]))
            pos = torch.arange(e.shape[1], dtype=torch.int32,
                               device=e.device)[None]
            if mesh is not None:
                e = maybe_shard(e, enc_specs.hid, mesh, bdim)
            e, _, _ = _run_stack([([b], False) for b in model.enc_layers],
                                 e, cfg, enc_specs, mode="encode",
                                 positions=pos, caches=None, whole=whole)
            enc_out = _norm(e, weight("enc_final_ln"), cfg)
            # the decoder's cross-attention reads the whole encoding
            enc_out = maybe_shard(enc_out, bdim, mesh, enc_specs.hid)
    # the hybrid's blocks drop their aux losses, as the reference's
    # _hybrid_apply does
    x, aux, new_caches = _run_stack(model.decoder_units(), x, cfg, specs,
                                    mode=mode, positions=positions,
                                    caches=caches, enc_out=enc_out,
                                    keep_aux=cfg.family != "hybrid",
                                    cache_specs=cache_specs, whole=whole)

    x = _norm(x, weight("final_ln"), cfg)
    head = embed.T if cfg.tie_embeddings else weight("lm_head")
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
