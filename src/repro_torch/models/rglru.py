"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The counterpart of ``repro/models/rglru.py``. The recurrence (Griffin
eq. 1-4):
    r_t = sigmoid(W_a x_t)                recurrence gate
    i_t = sigmoid(W_i x_t)                input gate
    log a_t = -c * softplus(Lambda) * r_t             (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
scanned in chunks as ``ssm.py`` scans, on a (B, d_rnn) state; decode
steps its cache in place as the SSM's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .modules import (FSDP, TP, _param, activation, linear_init, proj,
                      seq_whole, to_stream)
from .ssm import _advance, _causal_conv, softplus
from .ssm import _ssm_scan_chunked as _lru_scan_chunked

_C = 8.0


class RGLRUCache(NamedTuple):
    conv: torch.Tensor    # (B, conv_k - 1, d_rnn)
    h: torch.Tensor       # (B, d_rnn) float32
    length: torch.Tensor  # () int32


class RGLRU(torch.nn.Module):
    """in_x and in_gate (d, dr), conv_w (ck, dr), w_a and w_i (dr, dr),
    lam (dr,), out (dr, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        dr = cfg.d_rnn or d
        self.in_x = linear_init(d, dr, device)
        self.in_gate = linear_init(d, dr, device)
        self.conv_w = _param((cfg.ssm_conv, dr), device, (None, TP))
        self.w_a = linear_init(dr, dr, device, (None, TP))
        self.w_i = linear_init(dr, dr, device, (None, TP))
        self.lam = _param((dr,), device, (TP,))
        self.out = linear_init(dr, d, device, (TP, FSDP))


def rglru_apply(p: RGLRU, x: torch.Tensor, cfg, *, mode: str,
                cache: RGLRUCache | None = None, specs=None
                ) -> tuple[torch.Tensor, RGLRUCache | None]:
    """x (B, S, d); the modes and the mesh as ``ssm.ssm_apply``'s."""
    x, whole = seq_whole(x, specs)
    B, S, d = x.shape
    dr = cfg.d_rnn or d
    decode = mode == "decode"
    if decode and (cache is None or S != 1):
        raise ValueError("rglru_apply: mode='decode' needs a cache and S=1")

    gate = activation(proj(x, p.in_gate), "gelu")
    xr = proj(x, p.in_x)
    xc = _causal_conv(xr, p.conv_w, cache.conv if decode else None)

    r = torch.sigmoid(proj(xc, p.w_a).float())
    i = torch.sigmoid(proj(xc, p.w_i).float())
    a = torch.exp(-_C * softplus(p.lam.float()) * r)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xc.float())

    if decode:
        h = a[:, 0] * cache.h + gated[:, 0]
        hs = h[:, None]
        new_cache = _advance(cache, h, xr)
    else:
        h0 = torch.zeros((B, dr), dtype=torch.float32, device=x.device)
        hs, _ = _lru_scan_chunked(a, gated, h0, cfg.scan_chunk)
        new_cache = None

    y = hs.to(x.dtype) * gate
    return to_stream(proj(y, p.out), specs, whole), new_cache


def init_rglru_cache(cfg, B: int, dtype: torch.dtype, device=None
                     ) -> RGLRUCache:
    dr = cfg.d_rnn or cfg.d_model
    return RGLRUCache(
        conv=torch.zeros((B, cfg.ssm_conv - 1, dr), dtype=dtype,
                         device=device),
        h=torch.zeros((B, dr), dtype=torch.float32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )
