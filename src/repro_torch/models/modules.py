"""Module primitives of the LM substrate: parameter init and the norms,
rotary embedding and projection they share.

The counterpart of ``repro/models/modules.py``. Parameters live in
``torch.nn.Module``s (``transformer.py``) and keep the reference's
layouts: a linear weight is (d_in, d_out), the embedding (Vp, d), a norm
scale (d,). Each parameter declares its partition spec next to it, as
the reference's init functions do (``pspec``: ``linear_init`` (FSDP,
TP), ``embed_init`` (TP, None), norms replicated), with the placeholders
``FSDP`` and ``TP`` that ``parallel.mesh`` resolves for a mesh.

On a mesh (``parallel.Mesh``) a tensor is each rank's slice of it:
``maybe_shard`` moves one between the layouts the activation specs
name, and ``sp_out_proj`` is the out-projection's explicit
reduce-scatter over the sequence.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.parallel import group as _group

# logical axis placeholders; parallel/mesh.py maps them to mesh axes
FSDP = "__fsdp__"
TP = "__tp__"


class PartitionSpec(tuple):
    """One entry a dim of a tensor: None (whole on every rank), a mesh
    axis name, a tuple of names, or a placeholder (``FSDP``, ``TP``).
    The counterpart of ``jax.sharding.PartitionSpec``; a tuple, so specs
    compare with ``==``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


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


def _param(shape, device, pspec=None) -> torch.nn.Parameter:
    """An uninitialised float32 parameter of ``shape`` declaring its
    partition spec (``pspec``, default replicated) as ``p.pspec``; a
    deepcopy of the parameter drops it (``transformer.param_specs``)."""
    p = torch.nn.Parameter(
        torch.empty(shape, dtype=torch.float32, device=device),
        requires_grad=False)
    p.pspec = P(*(pspec if pspec is not None else (None,) * len(shape)))
    return p


def linear_init(d_in: int, d_out: int, device=None, pspec=(FSDP, TP)
                ) -> torch.nn.Parameter:
    """A (d_in, d_out) weight, filled by ``init_weights``."""
    return _param((d_in, d_out), device, pspec)


def embed_init(vocab: int, d: int, device=None) -> torch.nn.Parameter:
    return _param((vocab, d), device, (TP, None))


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


# --------------------------------------------------------------------------
# layouts on a mesh
# --------------------------------------------------------------------------


def full_dim(n: int, entry, mesh) -> int:
    """The full size of a dim a rank holds ``n`` of, split by ``entry``
    (fitted) over ``mesh`` (None: no mesh)."""
    return n if mesh is None else n * _group.axes_size(mesh, entry)


def maybe_shard(x: torch.Tensor, spec, mesh, frm=()) -> torch.Tensor:
    """The counterpart of the reference's shape-aware
    ``with_sharding_constraint``: ``x``, this rank's slice of a tensor in
    layout ``frm`` (fitted: each entry splits its dim), moved to layout
    ``spec``. A dim that becomes whole is all-gathered, a dim that
    becomes split is sliced (both differentiable); an entry of ``spec``
    whose axes do not divide the full dim falls back to None (e.g.
    whisper's 1500 frames under sequence parallelism). Nothing happens
    without a mesh."""
    if mesh is None:
        return x
    frm = tuple(frm) + (None,) * (x.dim() - len(tuple(frm)))
    full = [full_dim(n, e, mesh) for n, e in zip(x.shape, frm)]
    to = _group.fit_spec(spec or (), full, mesh)
    if to == frm:
        return x
    x = _group.gather_tensor(
        x, [f if f != t else None for f, t in zip(frm, to)], mesh)
    return _group.slice_tensor(
        x, [t if f != t else None for f, t in zip(frm, to)], mesh)


def seq_whole(x: torch.Tensor, specs):
    """A mixer's input on a mesh (``specs.mesh``): ``x``, the rank's
    block in ``specs.hid``, with its whole sequence, and that layout
    (the stream's batch entry, the rest whole). Without a mesh: ``x``
    and None."""
    if specs is None or specs.mesh is None:
        return x, None
    whole = P(specs.hid[0])
    return maybe_shard(x, whole, specs.mesh, specs.hid), whole


def to_stream(y: torch.Tensor, specs, whole) -> torch.Tensor:
    """A mixer's output (layout ``whole``, ``seq_whole``'s) returned to
    the stream's layout ``specs.hid``; as it is without a mesh."""
    return y if whole is None else maybe_shard(y, specs.hid, specs.mesh,
                                               whole)


def sp_out_proj(h: torch.Tensor, w: torch.Tensor, specs, fallback_spec,
                frm) -> torch.Tensor:
    """Feature-contracting out-projection with an explicit reduce-scatter.

    h: (B, S, f), this rank's batch block in layout ``frm`` with the
    whole sequence and every feature; w: (f, d) whole, or this rank's
    chunk of its rows over the tensor-parallel axis. The rank's slice of
    h's features times its row chunk of w is a partial sum over f; one
    reduce-scatter over the sequence in the tp group leaves (B, S/tp, d)
    in layout (frm's batch entry, tp, None). Falls back to the whole
    product moved to ``fallback_spec`` (``maybe_shard``) whenever the
    reference's does: no mesh or tp axis, tp of 1, or S or f not dividing
    over tp."""
    mesh, tp = getattr(specs, "mesh", None), getattr(specs, "tp", None)
    B, S, f = h.shape
    tp_n = mesh.axis_size(tp) if mesh is not None and tp is not None else 1
    local = tp_n > 1 and S % tp_n == 0 and f % tp_n == 0
    if w.shape[0] != f and not local:
        w = _group.all_gather(w, mesh.group(tp), 0)
    if not local:
        return maybe_shard(proj(h, w), fallback_spec, mesh, frm)
    r = mesh.axis_index(tp)
    c = f // tp_n
    if w.shape[0] == f:
        w = w.narrow(0, r * c, c)
    y = torch.matmul(h.narrow(2, r * c, c), w.to(h.dtype))
    return _group.reduce_scatter(y, mesh.group(tp), 1)


def resolve_pspec(tree: Any, *, fsdp_axes, tp_axis) -> Any:
    """Map the FSDP/TP placeholders in a tree of specs (dicts, lists and
    tuples of ``PartitionSpec``) to concrete mesh axes."""

    def fix(spec):
        return P(*(fsdp_axes if e == FSDP else tp_axis if e == TP else e
                   for e in spec))

    return tree_map(fix, tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (a
    ``PartitionSpec`` is a leaf, a NamedTuple keeps its type), with the
    matching leaves of ``rest``."""
    if isinstance(tree, PartitionSpec) or not isinstance(
            tree, (dict, list, tuple)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    out = [tree_map(fn, v, *(r[i] for r in rest))
           for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)
