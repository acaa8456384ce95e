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
rounding: uniform noise in [-0.5, 0.5) drawn in the leaf's stacked shape
from ``fold_in(fold_in(key(17), step), i)`` (``repro_torch.prng``), i
the leaf's index; then dequantizes it before the clip.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import prng


def _parts(leaf) -> list[torch.Tensor]:
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def _like(leaf, make):
    """``make`` applied to each tensor of ``leaf``, in ``leaf``'s form."""
    if isinstance(leaf, (list, tuple)):
        return [make(t) for t in leaf]
    return make(leaf)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over every tensor of its float32 sum of squares.
    Each sum of squares is ``sum()``'s (a cascade on the CPU): the CPU's
    float32 ``norm`` accumulates serially and is 1.5e-3 off at 28 M
    elements (smollm-135m's embedding)."""
    sums = []
    for k in sorted(grads):
        parts = [g.float() for g in _parts(grads[k])]
        sums += [sq.sum() for sq in torch._foreach_mul(parts, parts)]
    return torch.stack(sums).sum().sqrt()


def quantize_int8(g: torch.Tensor, noise: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic int8 rounding of ``g`` on one scale, ``max|g| / 127``;
    ``noise``: uniform in [-0.5, 0.5), ``g``'s shape (pre-drawn, as the
    port's kernels take their uniforms). Returns (q int8, scale)."""
    scale = g.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(g / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def _compress_int8(grads: dict, step: int) -> dict:
    """Each leaf quantized and dequantized on its own scale, its noise
    drawn on its device in its stacked shape."""
    key = prng.fold_in(prng.key(17), step)
    out = {}
    for i, k in enumerate(sorted(grads)):
        leaf = grads[k]
        g = torch.stack([t.float() for t in leaf]) \
            if isinstance(leaf, (list, tuple)) else leaf.float()
        gen = prng.generator(prng.fold_in(key, i), g.device)
        noise = torch.rand(g.shape, generator=gen, device=g.device,
                           dtype=torch.float32) - 0.5
        q, scale = quantize_int8(g, noise)
        deq = q.float() * scale
        out[k] = list(deq.unbind(0)) if isinstance(leaf, (list, tuple)) \
            else deq
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
                "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict
               ) -> tuple[dict, dict]:
        step = state["step"] + 1
        if self.grad_compress == "int8":
            grads = _compress_int8(grads, int(step))
        elif self.grad_compress != "none":
            raise ValueError(f"grad_compress={self.grad_compress!r} is "
                             f"neither 'none' nor 'int8'")
        gnorm = global_norm(grads)
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
