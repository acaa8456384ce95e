"""Mixture-of-Experts FFN: top-k routing, the global-capacity gather
dispatch, shared experts.

The counterpart of ``repro/models/moe.py``. The router takes a softmax
over the experts, then the top k, renormalised (DeepSeek-V2's
softmax-then-topk). Dispatch is sort-based: a stable sort of the (T, k)
expert ids gives each slot its rank within its expert, and the slots of
rank >= C (the capacity, from the static T) drop. The experts' GEMMs are
batched over a dense (E, C, d) layout, and ``n_shared_experts`` always-on
experts run as one dense SwiGLU of width shared * d_ff_expert.

The reference's other schedule, ``"a2a"`` (local tables, an all-to-all
over the mesh's tensor-parallel axis), needs a mesh (ROADMAP item 11c);
without one the reference takes the gather path for every
``moe_impl``, and so does the port.

Every table is built with static shapes and no host read: a dropped slot
is written to a spare column that is sliced away, and each token's k
expert outputs are gathered back and added in a fixed order (that of
their slots in the table, so by expert id, as the reference's
scatter-add meets them), with no atomics, so a decode step is the same
on every run.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .modules import _param, linear_init


class MoE(torch.nn.Module):
    """router (d, E); wi (E, d, 2 ff) fused gate and up, wo (E, ff, d);
    with shared experts shared_wi (d, 2 sh_ff), shared_wo (sh_ff, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, E = cfg.d_model, cfg.n_experts
        ff = cfg.d_ff_expert or cfg.d_ff
        self.router = linear_init(d, E, device)
        self.wi = _param((E, d, 2 * ff), device)
        self.wo = _param((E, ff, d), device)
        if cfg.n_shared_experts:
            sh_ff = cfg.n_shared_experts * ff
            self.shared_wi = linear_init(d, 2 * sh_ff, device)
            self.shared_wo = linear_init(sh_ff, d, device)


def _swiglu(x: torch.Tensor) -> torch.Tensor:
    g, u = x.chunk(2, dim=-1)
    return F.silu(g) * u


def _route(xt: torch.Tensor, router: torch.Tensor, E: int, k: int):
    """Router: probs, top-k gates and ids, and the load-balance aux
    ingredients. Returns (gate_vals (T, k) float32, expert_ids (T, k)
    int64, counts (E,) float32, prob_sum (E,) float32)."""
    logits = torch.matmul(xt, router.to(xt.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)     # descending
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    counts = torch.zeros(E, dtype=torch.float32, device=xt.device) \
        .index_add_(0, expert_ids.reshape(-1),
                    torch.ones(expert_ids.numel(), device=xt.device))
    return gate_vals, expert_ids, counts, probs.sum(dim=0)


def _dispatch(expert_ids: torch.Tensor, gate_vals: torch.Tensor,
              counts: torch.Tensor, E: int, C: int, T: int):
    """One stable sort of the flattened (T, k) ids gives each slot its
    rank within its expert; rank >= C drops. Returns the (E, C)
    token-index table (dropped and unfilled slots -> T, the zero row), the
    matching gate table (float32), and (T, k): where each token's routed
    slots sit in the flat (E C) table, E C (a zero row) for a dropped
    one, ascending."""
    k = expert_ids.shape[1]
    eid = expert_ids.reshape(-1)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    starts = (torch.cumsum(counts, 0) - counts).long()
    rank = torch.arange(T * k, device=eid.device) - starts[sorted_eid]
    keep = rank < C
    col = torch.where(keep, rank, C)  # the spare column C takes the drops
    tok = torch.arange(T, device=eid.device).repeat_interleave(k)
    table = torch.full((E, C + 1), T, dtype=torch.int64, device=eid.device)
    table.index_put_((sorted_eid, col), torch.where(keep, tok[order], T))
    gtable = torch.zeros((E, C + 1), dtype=torch.float32, device=eid.device)
    gtable.index_put_((sorted_eid, col),
                      torch.where(keep, gate_vals.reshape(-1)[order], 0.0))
    slots = torch.empty_like(eid)
    slots[order] = torch.where(keep, sorted_eid * C + rank, E * C)
    return (table[:, :C], gtable[:, :C],
            slots.reshape(T, k).sort(dim=1).values)


def _dispatch_tables(expert_ids: torch.Tensor, gate_vals: torch.Tensor,
                     counts: torch.Tensor, E: int, C: int, T: int):
    """(E, C) token-index table and gate table (``_dispatch``'s)."""
    return _dispatch(expert_ids, gate_vals, counts, E, C, T)[:2]


def _expert_ffn(xe: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor
                ) -> torch.Tensor:
    """Batched expert GEMMs: (E, C, d) -> (E, C, d)."""
    h = _swiglu(torch.bmm(xe, wi.to(xe.dtype)))
    return torch.bmm(h, wo.to(xe.dtype))


def _moe_gather(p: MoE, xt: torch.Tensor, cfg
                ) -> tuple[torch.Tensor, torch.Tensor]:
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    gate_vals, expert_ids, counts, prob_sum = _route(xt, p.router, E, k)
    aux = E * torch.sum((counts / T) * (prob_sum / T))
    C = max(1, int(T * k / E * cfg.capacity_factor))
    table, gtable, slots = _dispatch(expert_ids, gate_vals, counts, E, C, T)

    xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    ye = _expert_ffn(xpad[table], p.wi, p.wo)                 # (E, C, d)
    ye = ye * gtable[..., None].to(ye.dtype)
    # each token's k slots added in the table's order, in ye's dtype
    ye = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], dim=0)
    y = ye[slots[:, 0]]
    for j in range(1, k):
        y = y + ye[slots[:, j]]
    return y, aux


def _a2a_applicable(cfg, mesh, S: int) -> bool:
    """Whether the all-to-all schedule runs: never without a mesh, as the
    reference's decides when ``specs.mesh is None``; over a mesh's
    tensor-parallel axis it is ROADMAP item 11c."""
    return mesh is not None and cfg.moe_impl == "a2a"


def moe_apply(p: MoE, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d), aux_loss). x: (B, S, d)."""
    B, S, d = x.shape
    y, aux = _moe_gather(p, x.reshape(B * S, d), cfg)
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        sh = _swiglu(torch.matmul(x, p.shared_wi.to(x.dtype)))
        y = y + torch.matmul(sh, p.shared_wo.to(x.dtype))
    return y, aux
