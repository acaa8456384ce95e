"""Module primitives of the LM substrate: parameter init and the norms,
rotary embedding and projection they share.

The counterpart of ``repro/models/modules.py``. Parameters live in
``torch.nn.Module``s (``transformer.py``) and keep the reference's
layouts: a linear weight is (d_in, d_out), the embedding (Vp, d), a norm
scale (d,). The sharding specs (``sp_out_proj``, ``maybe_shard``,
``resolve_pspec``) are not ported yet (ROADMAP item 11c).
"""
from __future__ import annotations

import functools
import math

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
    ``named_parameters`` order from one generator, by name: the SSM's
    ``A_log`` (di, n) = log(1 + arange(n)) on every row (rounded
    once from float64), the RG-LRU's
    ``lam`` 0.65, ``conv_w`` 0.1 N(0, 1), the experts' ``moe.wi`` and
    ``moe.wo`` and ``enc_embed`` 0.02 N(0, 1); then every other vector
    (norm scales, the SSM's ``D``) ones and every other matrix
    ``truncated_normal_init``. Parameters on the meta device are left as
    they are."""
    for name, p in module.named_parameters():
        if p.device.type == "meta":
            continue
        leaf = name.split(".")[-1]
        with torch.no_grad():
            if leaf == "A_log":
                # in float64, so each value is log(1 + k) correctly rounded
                n = p.shape[-1]
                p.copy_(torch.log1p(torch.arange(
                    n, dtype=torch.float64, device=p.device)).expand_as(p))
            elif leaf == "lam":
                p.fill_(0.65)
            elif leaf == "conv_w":
                p.normal_(0.0, 1.0, generator=generator).mul_(0.1)
            elif leaf == "enc_embed" or name.endswith(("moe.wi", "moe.wo")):
                p.normal_(0.0, 1.0, generator=generator).mul_(0.02)
            elif p.dim() == 1:
                p.fill_(1.0)
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


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> tuple[float, ...]:
    """0.5, 1, sqrt(2/pi) and 0.044715 rounded to ``dtype``, as Python
    floats: made once a dtype on the host, since a 0-d tensor made on the
    card would be a copy from the host that waits for the device."""
    return tuple(float(torch.tensor(v, dtype=dtype))
                 for v in (0.5, 1.0, math.sqrt(2 / math.pi), 0.044715))


def gelu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, op by op in ``h``'s dtype
    with its constants rounded to that dtype, as JAX computes it: in bf16
    it so equals JAX's bitwise, where ``F.gelu`` (one rounding) differs in
    about 40% of the elements."""
    half, one, c, a = _gelu_constants(h.dtype)
    return h * (half * (one + torch.tanh(c * (h + a * (h * h * h)))))


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    return F.silu(h) if act == "silu" else gelu(h)
