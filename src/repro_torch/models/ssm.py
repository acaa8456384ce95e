"""Mamba-1 selective SSM (falcon-mamba-7b).

The counterpart of ``repro/models/ssm.py``. Train, prefill and encode
chunk the sequence into ``scan_chunk`` blocks, scan each chunk by
log-depth doubling (Hillis-Steele over the chunk axis, the counterpart
of the reference's ``associative_scan``) and carry the (B, di, n) state
across chunks, so memory is O(Lc · di · n), not O(S · di · n). Decode is
one step of the recurrence against the cache (the conv window and the
state), written in place as the attention caches are, so a step has
static shapes and reads nothing back to the host; prefill returns no
cache, as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .modules import (FSDP, TP, _param, linear_init, proj, seq_whole,
                      to_stream)


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, conv_k - 1, di): the last inputs of the conv
    h: torch.Tensor       # (B, di, n) float32: the ssm state
    length: torch.Tensor  # () int32


class SSM(torch.nn.Module):
    """in_proj (d, 2 di), conv_w (ck, di), x_proj (di, dt_rank + 2 n),
    dt_proj (dt_rank, di), A_log (di, n), D (di,), out_proj (di, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, di, n, dtr, ck = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                             cfg.dt_rank, cfg.ssm_conv)
        self.in_proj = linear_init(d, 2 * di, device)
        self.conv_w = _param((ck, di), device, (None, TP))
        self.x_proj = linear_init(di, dtr + 2 * n, device, (TP, None))
        self.dt_proj = linear_init(dtr, di, device, (None, TP))
        self.A_log = _param((di, n), device, (TP, None))
        self.D = _param((di,), device, (TP,))
        self.out_proj = linear_init(di, d, device, (TP, FSDP))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no switch to the
    identity at large x (``F.softplus``'s threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_scan_chunked(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                      chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bx_t over axis 1. a, bx: (B, S, *state);
    h0 (B, *state). Returns every h_t (B, S, *state) and the last. The
    RG-LRU's ``_lru_scan_chunked`` is this function on (B, S, dr)."""
    B, S = a.shape[:2]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:  # tail padding: outputs beyond S are sliced away below
        widths = (0, 0) * (a.dim() - 2) + (0, pad)
        a, bx = F.pad(a, widths), F.pad(bx, widths)
    hs, h = [], h0
    for j in range(0, S + pad, chunk):
        aa, bb = a[:, j:j + chunk], bx[:, j:j + chunk]
        # doubling: after the step of offset o, (aa_t, bb_t) composes the
        # 2o inputs ending at t; never a division by a product of a
        o = 1
        while o < aa.shape[1]:
            aa, bb = (torch.cat([aa[:, :o], aa[:, o:] * aa[:, :-o]], 1),
                      torch.cat([bb[:, :o], aa[:, o:] * bb[:, :-o] + bb[:, o:]],
                                1))
            o *= 2
        # fold in the carried state: h_t = aa_t * h + bb_t
        hc = aa * h[:, None] + bb
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, 1)[:, :S], h


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along axis 1. x (B, S, di), w (ck, di),
    history (B, ck - 1, di) or zeros. The ck taps are summed one after
    another in the promoted dtype (four bf16 adds in bf16), then cast to
    ``x.dtype``, as the reference's sum is."""
    ck, S = w.shape[0], x.shape[1]
    if history is None:
        xp = F.pad(x, (0, 0, ck - 1, 0))
    else:
        xp = torch.cat([history, x], dim=1)
    out = xp[:, 0:S] * w[0]
    for i in range(1, ck):
        out = out + xp[:, i:i + S] * w[i]
    return out.to(x.dtype)


def _advance(cache, h: torch.Tensor, x_new: torch.Tensor):
    """A decode step's cache update, in place: the conv window shifted by
    one input (B, 1, width) and the state ``h``; the length advanced as a
    new 0-d device tensor (the caller's decode positions view the old
    one), as ``attention``'s caches advance it."""
    cache.h.copy_(h)
    cache.conv.copy_(torch.cat([cache.conv[:, 1:], x_new], dim=1))
    return cache._replace(length=cache.length + 1)


def ssm_apply(p: SSM, x: torch.Tensor, cfg, *, mode: str,
              cache: SSMCache | None = None, specs=None
              ) -> tuple[torch.Tensor, SSMCache | None]:
    """x (B, S, d). ``mode="decode"`` (S = 1) steps ``cache`` in place and
    returns it with the length advanced; every other mode scans the
    sequence from a zero state and returns no cache. On a mesh
    (``specs.mesh``) x is the rank's block in ``specs.hid``: the scan
    runs on its whole sequence, and the output returns to that layout."""
    x, whole = seq_whole(x, specs)
    B, S, _ = x.shape
    di, n, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank

    xin, z = proj(x, p.in_proj).chunk(2, dim=-1)  # (B, S, di) each
    decode = mode == "decode"
    if decode and (cache is None or S != 1):
        raise ValueError("ssm_apply: mode='decode' needs a cache and S=1")
    xc = F.silu(_causal_conv(xin, p.conv_w, cache.conv if decode else None))

    dt_r, b_ssm, c_ssm = proj(xc, p.x_proj).split([dtr, n, n], dim=-1)
    dt = softplus(proj(dt_r, p.dt_proj)).float()
    A = -torch.exp(p.A_log.float())                        # (di, n)
    a_bar = torch.exp(dt[..., None] * A)                   # (B, S, di, n)
    bx = dt[..., None] * b_ssm.float()[:, :, None, :] * xc.float()[..., None]

    if decode:
        h = a_bar[:, 0] * cache.h + bx[:, 0]               # (B, di, n)
        y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0].float())[:, None]
        new_cache = _advance(cache, h, xin)
    else:
        h0 = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
        hs, _ = _ssm_scan_chunked(a_bar, bx, h0, cfg.scan_chunk)
        y = torch.einsum("bsdn,bsn->bsd", hs, c_ssm.float())
        new_cache = None

    y = y + xc.float() * p.D.float()
    y = y.to(x.dtype) * F.silu(z)
    return to_stream(proj(y, p.out_proj), specs, whole), new_cache


def init_ssm_cache(cfg, B: int, dtype: torch.dtype, device=None) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((B, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        h=torch.zeros((B, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                      device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )
