"""Module primitives of the LM substrate: parameter init and the norms,
rotary embedding and projection they share.

The counterpart of ``repro/models/modules.py``. Parameters live in
``torch.nn.Module``s (``transformer.py``) and keep the reference's
layouts: a linear weight is (d_in, d_out), the embedding (Vp, d), a norm
scale (d,). The sharding specs (``sp_out_proj``, ``maybe_shard``,
``resolve_pspec``) are not ported yet (ROADMAP item 11c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def truncated_normal_init(w: torch.Tensor, scale: float = 1.0,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    """Fill ``w`` in place: ``scale / sqrt(fan_in)`` times a standard
    normal truncated to ±2, fan_in = ``shape[-2]`` (``shape[-1]`` for a
    vector). The embedding (Vp, d) so gets 1/sqrt(Vp), as in the
    reference."""
    fan_in = w.shape[-2] if w.dim() >= 2 else w.shape[-1]
    std = scale / max(1.0, fan_in) ** 0.5
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        w.mul_(std)
    return w


def _param(shape, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(
        torch.empty(shape, dtype=torch.float32, device=device),
        requires_grad=False)


def linear_init(d_in: int, d_out: int, device=None) -> torch.nn.Parameter:
    """A (d_in, d_out) weight, filled by ``init_weights``."""
    return _param((d_in, d_out), device)


def embed_init(vocab: int, d: int, device=None) -> torch.nn.Parameter:
    return _param((vocab, d), device)


def norm_init(d: int, device=None) -> torch.nn.Parameter:
    return _param((d,), device)


def init_weights(module: torch.nn.Module, generator: torch.Generator
                 ) -> None:
    """The reference's initialisers over every parameter of ``module``, in
    ``named_parameters`` order from one generator: norm scales ones,
    ``enc_embed`` 0.02 N(0, 1), every other matrix ``truncated_normal_init``.
    Parameters on the meta device are left as they are."""
    for name, p in module.named_parameters():
        if p.device.type == "meta":
            continue
        with torch.no_grad():
            if p.dim() == 1:
                p.fill_(1.0)
            elif name.split(".")[-1] == "enc_embed":
                p.normal_(0.0, 1.0, generator=generator).mul_(0.02)
            else:
                truncated_normal_init(p, 1.0, generator)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as the reference's
    einsums compute a bf16 activation against a float32 weight."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None = None, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rope_dim: int | None = None) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved), on the first
    ``rope_dim`` features (default all). x: (..., S, H, hd) or (..., S,
    hd); positions (..., S)."""
    hd = x.shape[-1]
    rd = rope_dim or hd
    half = rd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    if x.dim() == ang.dim() + 1:  # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rd].float()
    x1, x2 = xr[..., :half], xr[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rd:]], dim=-1)


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
