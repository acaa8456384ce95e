"""Attention flavors: GQA/MHA (with cross-attention and a local window)
and MLA (DeepSeek/MiniCPM).

The counterpart of ``repro/models/attention.py``. Activations are (B, S,
d); projections are (d_in, d_out) matrix products (``modules.proj``).

Prefill/train uses chunked attention (a loop over KV chunks with an online
softmax), so the S x S score matrix never materializes. Decode reads one
token against a static-length cache. MLA decode uses the absorbed-weights
form (q projected into the latent space, the context read there), so its
cache is (kv_lora + rope) wide.

A decode step writes its token's keys and values into the cache's
tensors in place (no copy of the cache a step) and returns them with the
length advanced; the length is a 0-d int32 tensor on the cache's device,
so a step never waits for the host.

On a mesh (``specs.mesh``) a mixer gathers the sequence of its input
block (``maybe_shard`` to the stream's batch entry, the rest whole),
computes every head on it, and returns its output to the stream's
layout: in training under sequence parallelism through ``sp_out_proj``
(the rank's features times its rows of ``wo``, one reduce-scatter over
the sequence), else by slicing the whole out-projection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .modules import (FSDP, TP, linear_init, proj, rope, seq_whole,
                      sp_out_proj, to_stream)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_cache, KV, hd) GQA; MLA: c_kv (B, S, r)
    v: torch.Tensor       # (B, S_cache, KV, hd) GQA; MLA: k_rope (B, S, rd)
    length: torch.Tensor  # () int32: valid prefix length


# --------------------------------------------------------------------------
# chunked (flash-style) softmax attention
# --------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,              # (B, Sq, KV, G, hd)
    k: torch.Tensor,              # (B, Sk, KV, hd)
    v: torch.Tensor,              # (B, Sk, KV, hd_v)
    *,
    chunk: int,
    causal: bool,
    q_offset: torch.Tensor | int = 0,  # position of q[0] in the kv timeline
    window: int = 0,                   # 0 = global
) -> torch.Tensor:
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = hd ** -0.5
    qf = q.float() * scale
    q_pos = torch.arange(Sq, device=q.device) + q_offset  # (Sq,)

    hd_v = v.shape[-1]  # may differ from q/k head dim (MLA: nope+rope vs v)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd_v), dtype=torch.float32,
                      device=q.device)
    for j in range(n_chunks):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk].float()
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, kj)  # (B, KV, G, Sq, C)
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        valid = (k_pos < Sk)[None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        if window:
            valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckh->bkgqh", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    # (B, KV, G, Sq, hd) -> (B, Sq, KV, G, hd)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _softmax_read(q, k, v, valid) -> torch.Tensor:
    """One query step against a whole cache under a (S,) validity mask."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bckh->bkgqc", q.float() * scale, k.float())
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bkgqh", p, v.float())
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def decode_attention(
    q: torch.Tensor,       # (B, 1, KV, G, hd)
    k: torch.Tensor,       # (B, S, KV, hd)
    v: torch.Tensor,       # (B, S, KV, hd)
    length: torch.Tensor,  # () valid cache length (new token at length-1)
    window: int = 0,
) -> torch.Tensor:
    pos = torch.arange(k.shape[1], device=k.device)
    valid = pos < length
    if window:
        valid = valid & (pos >= length - window)
    return _softmax_read(q, k, v, valid)


def _ring_decode(q, k, v, length, window):
    """Decode attention over a ring buffer: all slots valid once
    length >= window."""
    pos = torch.arange(k.shape[1], device=k.device)
    valid = (pos < length) | (length >= window)
    return _softmax_read(q, k, v, valid)


def _write(buf: torch.Tensor, new: torch.Tensor, at: torch.Tensor) -> None:
    """``buf[:, at] = new[:, 0]`` in place; ``at`` a 0-d tensor, clamped to
    the buffer as ``dynamic_update_slice`` clamps its start."""
    idx = at.clamp(max=buf.shape[1] - 1).long().reshape(1)
    buf.index_copy_(1, idx, new.to(buf.dtype))


def _out_proj(out: torch.Tensor, wo: torch.Tensor, specs, mode: str,
              whole) -> torch.Tensor:
    """``out @ wo`` in the stream's layout: under sequence parallelism
    in training, ``sp_out_proj``'s reduce-scatter; else the whole product
    moved there (``maybe_shard``)."""
    if whole is None:
        return proj(out, wo)
    if mode == "train" and specs.hid[1] is not None:
        return sp_out_proj(out, wo, specs, specs.hid, whole)
    return to_stream(proj(out, wo), specs, whole)


# --------------------------------------------------------------------------
# GQA block
# --------------------------------------------------------------------------


class GQA(torch.nn.Module):
    """wq (d, H hd), wk and wv (d, KV hd), wo (H hd, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = linear_init(d, H * hd, device)
        self.wk = linear_init(d, KV * hd, device)
        self.wv = linear_init(d, KV * hd, device)
        self.wo = linear_init(H * hd, d, device, (TP, FSDP))


def gqa_apply(
    p: GQA,
    x: torch.Tensor,                   # (B, S, d)
    cfg,
    *,
    mode: str,                         # train | prefill | decode | encode
    positions: torch.Tensor | None = None,
    cache: KVCache | None = None,
    kv_src: torch.Tensor | None = None,   # cross-attention source (enc-dec)
    window: int = 0,
    specs=None,                # ActSpecs: on a mesh, the stream's layout
) -> tuple[torch.Tensor, KVCache | None]:
    x, whole = seq_whole(x, specs)
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    src = x if kv_src is None else kv_src
    q = proj(x, p.wq)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    q = q.reshape(B, S, KV, G, hd)

    if mode == "decode":
        if cache is None:
            raise ValueError("gqa_apply: mode='decode' needs a cache")
        k_new = proj(src, p.wk).reshape(B, S, KV, hd)
        v_new = proj(src, p.wv).reshape(B, S, KV, hd)
        k_new = rope(k_new, positions, cfg.rope_theta)
        length = cache.length + 1
        if window and cache.k.shape[1] == window:
            # ring buffer (local attention): write at length % window
            slot = cache.length % window
            _write(cache.k, k_new, slot)
            _write(cache.v, v_new, slot)
            # ring semantics: everything in the buffer is valid once warm
            out = _ring_decode(q, cache.k, cache.v, length, window)
        else:
            _write(cache.k, k_new, cache.length)
            _write(cache.v, v_new, cache.length)
            out = decode_attention(q, cache.k, cache.v, length, window)
        new_cache = KVCache(cache.k, cache.v, length)
    else:
        Sk = src.shape[1]
        k = proj(src, p.wk).reshape(B, Sk, KV, hd)
        if kv_src is None:
            kv_pos = positions
        else:
            kv_pos = torch.arange(Sk, device=x.device)[None, :]
        k = rope(k, kv_pos, cfg.rope_theta)
        v = proj(src, p.wv).reshape(B, Sk, KV, hd)
        causal = kv_src is None and mode != "encode"
        out = chunked_attention(q, k, v, chunk=cfg.attn_chunk, causal=causal,
                                window=window)
        new_cache = None

    return _out_proj(out.reshape(B, S, H * hd), p.wo, specs, mode,
                     whole), new_cache


# --------------------------------------------------------------------------
# MLA block (DeepSeek-V2 / MiniCPM3)
# --------------------------------------------------------------------------


class MLA(torch.nn.Module):
    """wdq (d, q_lora) and wuq (q_lora, H (nd+rd)), or wq (d, H (nd+rd));
    wdkv (d, r), wkr (d, rd), wuk (r, H nd), wuv (r, H hd), wo (H hd, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
        nd = cfg.qk_nope_dim or hd
        if cfg.q_lora_rank:
            self.wdq = linear_init(d, cfg.q_lora_rank, device, (FSDP, None))
            self.wuq = linear_init(cfg.q_lora_rank, H * (nd + rd), device)
        else:
            self.wq = linear_init(d, H * (nd + rd), device)
        self.wdkv = linear_init(d, r, device, (FSDP, None))
        self.wkr = linear_init(d, rd, device, (FSDP, None))
        self.wuk = linear_init(r, H * nd, device)
        self.wuv = linear_init(r, H * hd, device)
        self.wo = linear_init(H * hd, d, device, (TP, FSDP))


def mla_apply(
    p: MLA,
    x: torch.Tensor,
    cfg,
    *,
    mode: str,
    positions: torch.Tensor | None = None,
    cache: KVCache | None = None,
    specs=None,                # ActSpecs: on a mesh, the stream's layout
) -> tuple[torch.Tensor, KVCache | None]:
    x, whole = seq_whole(x, specs)
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    nd = cfg.qk_nope_dim or hd
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]

    if cfg.q_lora_rank:
        q = proj(proj(x, p.wdq), p.wuq)
    else:
        q = proj(x, p.wq)
    q = q.reshape(B, S, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    c_new = proj(x, p.wdkv)                                 # latent KV
    kr_new = rope(proj(x, p.wkr), positions, cfg.rope_theta)

    if mode == "decode":
        if cache is None:
            raise ValueError("mla_apply: mode='decode' needs a cache")
        _write(cache.k, c_new, cache.length)
        _write(cache.v, kr_new, cache.length)
        c, kr = cache.k, cache.v
        length = cache.length + 1
        # absorbed form: score in latent space
        wuk = p.wuk.reshape(r, H, nd)
        dt = torch.promote_types(q_nope.dtype, wuk.dtype)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.to(dt), wuk.to(dt))
        scale = (nd + rd) ** -0.5
        dt_s = torch.promote_types(q_lat.dtype, c.dtype)
        s = (torch.einsum("bshr,bcr->bhsc", q_lat.to(dt_s), c.to(dt_s))
             + torch.einsum("bshr,bcr->bhsc", q_rope.to(dt_s), kr.to(dt_s))
             ) * scale
        pos = torch.arange(c.shape[1], device=x.device)
        s = torch.where((pos < length)[None, None, None, :], s, NEG_INF)
        w = torch.softmax(s.float(), dim=-1)
        ctx = torch.einsum("bhsc,bcr->bshr", w, c.float())   # latent ctx
        wuv = p.wuv.reshape(r, H, hd)
        dt = torch.promote_types(x.dtype, wuv.dtype)
        out = torch.einsum("bshr,rhv->bshv", ctx.to(x.dtype).to(dt),
                           wuv.to(dt))
        new_cache = KVCache(c, kr, length)
    else:
        k_nope = proj(c_new, p.wuk).reshape(B, S, H, nd)
        v = proj(c_new, p.wuv).reshape(B, S, H, hd)
        k = torch.cat([k_nope, kr_new[:, :, None, :].expand(B, S, H, rd)
                       .to(k_nope.dtype)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(
            qq.reshape(B, S, H, 1, nd + rd), k, v,
            chunk=cfg.attn_chunk, causal=True,
        ).reshape(B, S, H, hd)
        new_cache = None

    return _out_proj(out.reshape(B, S, H * hd), p.wo, specs, mode,
                     whole), new_cache


def init_gqa_cache(cfg, B: int, S: int, dtype: torch.dtype, device=None,
                   window: int = 0) -> KVCache:
    KV, hd = cfg.n_kv_heads, cfg.hd
    Sc = min(S, window) if window else S
    return KVCache(
        k=torch.zeros((B, Sc, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((B, Sc, KV, hd), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_mla_cache(cfg, B: int, S: int, dtype: torch.dtype, device=None
                   ) -> KVCache:
    return KVCache(
        k=torch.zeros((B, S, cfg.kv_lora_rank), dtype=dtype, device=device),
        v=torch.zeros((B, S, cfg.qk_rope_dim), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )
