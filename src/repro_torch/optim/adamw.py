"""AdamW with global-norm clipping, and SGD with momentum.

The counterpart of ``repro/optim/adamw.py``, the reference's formula
rather than ``torch.optim.AdamW``'s: the clip scale is ``min(1,
clip_norm / (|g| + 1e-9))``, the schedule is read at the incremented
(1-based) step, the weight decay is added to the update before the lr
multiplies it, the bias corrections are ``1 - b ** step`` in float32,
``m`` and ``v`` are float32 and each new parameter is cast back to its
own dtype.

The parameters are a dict of leaves, visited in sorted key order as
``jax.tree`` visits the reference's param tree. A leaf is a tensor, or
a list of tensors: the slices of one stacked (L, ...) leaf of the
reference, one a layer (``interop.reference_leaves`` builds this dict
for a model). ``update`` writes the new values into the parameters
and the moments in place and returns them with the new state; the state
is ``{"m", "v", "step"}``, ``m`` and ``v`` shaped as the parameters,
``step`` a 0-d int32 tensor on the host, so that a checkpoint keeps the
reference's layout.

``grad_compress="int8"`` quantizes each leaf's gradient to int8 with
one scale a leaf, a stacked leaf's layers together, and stochastic
rounding: uniform noise in [-0.5, 0.5) drawn from ``fold_in(fold_in(
key(17), step), i)`` (``repro_torch.prng``), i the leaf's index, a
stacked leaf's layer l from ``fold_in`` of that and l; then dequantizes
it before the clip.

On a mesh (``update(..., mesh=, shardings=)``, ``shardings`` one
``parallel.Sharding`` a tensor of each leaf) the parameters, gradients
and moments are each rank's slices and every step is the unsharded
step's: the global norm sums each slice's squares once (on the first of
the ranks holding it) and all-reduces; an int8 scale's max|g| is taken
over the whole leaf (one all-gather of every leaf's local max); each
tensor's noise is drawn in its whole shape and sliced, so q is the
unsharded q bitwise on the same gradient (a tensor whose whole float32
noise passes ``NOISE_LIMIT_BYTES`` raises: it would not fit beside the
rank's state).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import prng
from repro_torch.parallel import group as _group


def _parts(leaf) -> list[torch.Tensor]:
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def _like(leaf, make):
    """``make`` applied to each tensor of ``leaf``, in ``leaf``'s form."""
    if isinstance(leaf, (list, tuple)):
        return [make(t) for t in leaf]
    return make(leaf)


def global_norm(grads: dict, mesh=None, shardings: dict | None = None
                ) -> torch.Tensor:
    """sqrt of the sum over every tensor of its float32 sum of squares.
    Each sum of squares is ``sum()``'s (a cascade on the CPU): the CPU's
    float32 ``norm`` accumulates serially and is 1.5e-3 off at 28 M
    elements (smollm-135m's embedding). On a mesh a slice counts on the
    first rank of those holding it (``parallel.is_owner``), and the
    ranks' sums are all-reduced."""
    sums = []
    for k in sorted(grads):
        parts = [g.float() for g in _parts(grads[k])]
        sq = [t.sum() for t in torch._foreach_mul(parts, parts)]
        if mesh is not None:
            sq = [t for t, sh in zip(sq, _parts(shardings[k]))
                  if _group.is_owner(sh.spec, mesh)]
        sums += sq
    if mesh is None:
        return torch.stack(sums).sum().sqrt()
    # a rank may own no slice (every leaf it holds has a first holder)
    total = torch.stack(sums).sum() if sums else torch.zeros(
        (), device=_parts(grads[min(grads)])[0].device)
    return _group.all_reduce_sum(total).sqrt()


def quantize_int8(g: torch.Tensor, noise: torch.Tensor,
                  amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic int8 rounding of ``g`` on one scale, ``max|g| / 127``
    (``amax``: max|g| when g is a slice of the leaf); ``noise``: uniform
    in [-0.5, 0.5), ``g``'s shape (pre-drawn, as the port's kernels take
    their uniforms). Returns (q int8, scale)."""
    scale = (g.abs().max() if amax is None else amax) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g / scale + noise), -127, 127)
    return q.to(torch.int8), scale


# int8 compression on a mesh draws each tensor's noise whole on every rank
# and keeps the rank's slice: a draw is held to a quarter of an H100's
# 80 GB (a stacked leaf draws a layer at a time)
NOISE_LIMIT_BYTES = 20 * 10**9


def _compress_int8(grads: dict, step: int, mesh=None,
                   shardings: dict | None = None) -> dict:
    """Each leaf quantized and dequantized on its own scale, a stacked
    leaf's layers together. The noise of leaf i is drawn on its device
    from ``fold_in(fold_in(key(17), step), i)``, a stacked leaf's layer
    l from ``fold_in`` of that and l; on a mesh it is drawn in the
    tensor's whole shape and sliced to the rank's part, and a draw of
    more than ``NOISE_LIMIT_BYTES`` raises."""
    key = prng.fold_in(prng.key(17), step)
    keys = sorted(grads)
    amax = None
    if mesh is not None:
        for k in keys:
            for sh in _parts(shardings[k]):
                if 4 * math.prod(sh.shape) > NOISE_LIMIT_BYTES:
                    raise ValueError(
                        f"int8 compression on a mesh: leaf {k}'s noise, "
                        f"drawn whole in float32 {tuple(sh.shape)}, passes "
                        f"NOISE_LIMIT_BYTES = {NOISE_LIMIT_BYTES}")
        local = torch.stack([torch.stack([t.float().abs().max()
                                          for t in _parts(grads[k])]).max()
                             for k in keys])
        amax = _group.all_gather_rows(local[None]).amax(dim=0)
    out = {}
    for i, k in enumerate(keys):
        leaf = grads[k]
        stacked = isinstance(leaf, (list, tuple))
        parts = _parts(leaf)
        shs = _parts(shardings[k]) if mesh is not None else [None] * len(parts)
        noise = []
        for j, (t, sh) in enumerate(zip(parts, shs)):
            gen = prng.generator(prng.fold_in(prng.fold_in(key, i), j)
                                 if stacked else prng.fold_in(key, i),
                                 t.device)
            n = torch.rand(t.shape if sh is None else sh.shape,
                           generator=gen, device=t.device,
                           dtype=torch.float32).sub_(0.5)
            noise.append(n if sh is None
                         else _group.shard_tensor(n, sh.spec, mesh))
            del n  # a whole draw is freed before the next one is made
        g = torch.stack([t.float() for t in parts]) if stacked \
            else leaf.float()
        noise = torch.stack(noise) if stacked else noise[0]
        q, scale = quantize_int8(g, noise,
                                 None if amax is None else amax[i])
        deq = q.float() * scale
        out[k] = list(deq.unbind(0)) if stacked else deq
    return out


def _f32(x) -> float:
    """A Python float holding float32 ``x`` exactly."""
    return float(torch.as_tensor(x, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compress: str = "none"   # "none" | "int8"

    def init(self, params: dict) -> dict:
        def zeros(leaf):
            return _like(leaf, lambda p: torch.zeros_like(
                p, dtype=torch.float32, requires_grad=False))
        return {"m": {k: zeros(v) for k, v in params.items()},
                "v": {k: zeros(v) for k, v in params.items()},
                "step": torch.tensor(0, dtype=torch.int32)}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict, *,
               mesh=None, shardings: dict | None = None
               ) -> tuple[dict, dict]:
        step = state["step"] + 1
        if self.grad_compress == "int8":
            grads = _compress_int8(grads, int(step), mesh, shardings)
        elif self.grad_compress != "none":
            raise ValueError(f"grad_compress={self.grad_compress!r} is "
                             f"neither 'none' nor 'int8'")
        gnorm = global_norm(grads, mesh, shardings)
        scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
        lr = _f32(self.lr(step) if callable(self.lr) else self.lr)
        b1, b2 = self.b1, self.b2
        s = step.to(torch.float32)
        bc1 = _f32(1 - torch.tensor(b1, dtype=torch.float32) ** s)
        bc2 = _f32(1 - torch.tensor(b2, dtype=torch.float32) ** s)
        m_new, v_new = {}, {}
        for k in sorted(params):
            P = _parts(params[k])
            g = torch._foreach_mul([t.float() for t in _parts(grads[k])],
                                   scale)
            m, v = _parts(state["m"][k]), _parts(state["v"][k])
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(
                torch._foreach_mul(g, 1 - b2), g))
            u = torch._foreach_div(m, bc1)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(u, den)
            p32 = [p.float() for p in P]
            torch._foreach_add_(u, torch._foreach_mul(p32,
                                                      self.weight_decay))
            torch._foreach_copy_(P, torch._foreach_sub(
                p32, torch._foreach_mul(u, lr)))
            wrap = isinstance(params[k], (list, tuple))
            m_new[k] = m if wrap else m[0]
            v_new[k] = v if wrap else v[0]
        return params, {"m": m_new, "v": v_new, "step": step}


def sgd_momentum(lr: float = 0.1, momentum: float = 0.9):
    @dataclasses.dataclass(frozen=True)
    class _SGD:
        def init(self, params: dict) -> dict:
            return {"mom": {k: _like(v, lambda p: torch.zeros_like(
                        p, dtype=torch.float32, requires_grad=False))
                            for k, v in params.items()},
                    "step": torch.zeros((), dtype=torch.int32)}

        @torch.no_grad()
        def update(self, params: dict, grads: dict, state: dict
                   ) -> tuple[dict, dict]:
            mom_new = {}
            for k in sorted(params):
                mom = [momentum * m + g.float() for m, g in
                       zip(_parts(state["mom"][k]), _parts(grads[k]))]
                for p, m in zip(_parts(params[k]), mom):
                    p.copy_(p.float() - lr * m)
                mom_new[k] = mom if isinstance(params[k], (list, tuple)) \
                    else mom[0]
            return params, {"mom": mom_new, "step": state["step"] + 1}

    return _SGD()
