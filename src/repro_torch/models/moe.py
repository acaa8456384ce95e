"""Mixture-of-Experts FFN: top-k routing, the global-capacity gather
dispatch, shared experts.

The counterpart of ``repro/models/moe.py``. The router takes a softmax
over the experts, then the top k, renormalised (DeepSeek-V2's
softmax-then-topk). Dispatch is sort-based: a stable sort of the (T, k)
expert ids gives each slot its rank within its expert, and the slots of
rank >= C (the capacity, from the static T) drop. The experts' GEMMs are
batched over a dense (E, C, d) layout, and ``n_shared_experts`` always-on
experts run as one dense SwiGLU of width shared * d_ff_expert.

``cfg.moe_impl`` selects the dispatch on a mesh (``specs.mesh``), as the
reference's does:

* ``"gather"``, and every case ``_a2a_applicable`` refuses (no mesh, a
  decode step's S = 1): the global-capacity table over every token of
  the batch. On a mesh the rank's tokens are all-gathered first, the
  dispatch runs on all of them (the reference's arithmetic: one global
  capacity) and the rank keeps its block of the output.
* ``"a2a"``: tokens stay split over (dp on batch, tp on sequence); each
  rank builds local (E, C_dev) tables from its own tokens (capacity per
  device, GShard's group semantics), all-to-alls the (E, C_dev, d) slabs
  over the tp group, so each rank runs its own E/tp experts on what
  every rank of the group sent them, with no gather of the experts'
  weights, and reverses the all-to-all. The load-balance aux loss comes
  from the global counts and prob sums, one all-reduce over the axes
  the tokens are split over.

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

from repro_torch.parallel import group as _group

from .modules import FSDP, TP, P, _param, full_dim, linear_init, maybe_shard


class MoE(torch.nn.Module):
    """router (d, E); wi (E, d, 2 ff) fused gate and up, wo (E, ff, d);
    with shared experts shared_wi (d, 2 sh_ff), shared_wo (sh_ff, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, E = cfg.d_model, cfg.n_experts
        ff = cfg.d_ff_expert or cfg.d_ff
        self.router = linear_init(d, E, device, (FSDP, None))
        # experts: fused gate+up (E, d, 2ff), down (E, ff, d); E over TP
        self.wi = _param((E, d, 2 * ff), device, (TP, FSDP, None))
        self.wo = _param((E, ff, d), device, (TP, None, FSDP))
        if cfg.n_shared_experts:
            sh_ff = cfg.n_shared_experts * ff
            self.shared_wi = linear_init(d, 2 * sh_ff, device)
            self.shared_wo = linear_init(sh_ff, d, device, (TP, FSDP))


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
    ye = _expert_ffn(_rows(xt, table), p.wi, p.wo)            # (E, C, d)
    return _combine(ye, gtable, slots), aux


def _rows(xt: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The (E, C, d) expert inputs: the table's token rows, the zero row
    for an empty slot."""
    xpad = torch.cat([xt, xt.new_zeros((1, xt.shape[1]))], dim=0)
    return xpad[table]


def _combine(ye: torch.Tensor, gtable: torch.Tensor, slots: torch.Tensor
             ) -> torch.Tensor:
    """Each token's k slots of ``ye`` (E, C, d), gated, added in the
    table's order, in ye's dtype: (T, d)."""
    E, C, d = ye.shape
    ye = ye * gtable[..., None].to(ye.dtype)
    ye = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], dim=0)
    y = ye[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        y = y + ye[slots[:, j]]
    return y


def _a2a_applicable(cfg, specs, S: int) -> bool:
    """Whether the all-to-all schedule runs: on a mesh with a tp axis of
    more than one rank that divides the experts, and a sequence S that
    splits over it (train and prefill); decode (S = 1) keeps the gather
    path, whose global capacity drops fewer tokens at tiny T."""
    if (cfg.moe_impl != "a2a" or specs is None or specs.mesh is None
            or specs.tp is None):
        return False
    tp_n = int(specs.mesh.axis_size(specs.tp))
    return cfg.n_experts % tp_n == 0 and tp_n > 1 and S % tp_n == 0


def _moe_a2a(p: MoE, x: torch.Tensor, cfg, specs
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Local dispatch -> all-to-all -> the rank's expert GEMMs ->
    all-to-all -> combine. x: the rank's block in ``specs.hid``; its
    tokens split over (``hid``'s batch entry, tp on the sequence) for the
    exchange. ``p.wi``/``p.wo`` are the rank's expert slabs (E/tp, ...),
    or whole (its slab is taken)."""
    mesh, tp = specs.mesh, specs.tp
    E, k = cfg.n_experts, cfg.top_k
    bdim = specs.hid[0]
    x_spec = P(bdim, tp, None)
    T_global = (full_dim(x.shape[0], bdim, mesh)
                * full_dim(x.shape[1], specs.hid[1], mesh))
    xs = maybe_shard(x, x_spec, mesh, specs.hid)
    Bl, Sl, d = xs.shape
    T = Bl * Sl
    xt = xs.reshape(T, d)
    gate_vals, expert_ids, counts, prob_sum = _route(xt, p.router, E, k)
    # load-balance aux from the GLOBAL stats (one all-reduce of (2E,))
    stat_axes = _group.entry_axes(bdim) + (tp,)
    g_counts, g_prob = _group.all_reduce_sum(
        counts, prob_sum, group=_group.axes_group(mesh, stat_axes))
    aux = E * torch.sum((g_counts / T_global) * (g_prob / T_global))

    C = max(1, int(T * k / E * cfg.capacity_factor))
    table, gtable, slots = _dispatch(expert_ids, gate_vals, counts, E, C, T)
    group = mesh.group(tp)
    # exchange: every rank sends expert block j to tp rank j
    xe = _group.all_to_all(_rows(xt, table), group, 0, 1)  # (E/tp, C tp, d)
    E_loc, r = E // group.size, mesh.axis_index(tp)
    wi, wo = p.wi, p.wo
    if wi.shape[0] == E:
        wi, wo = wi.narrow(0, r * E_loc, E_loc), wo.narrow(0, r * E_loc, E_loc)
    ye = _expert_ffn(xe, wi, wo)
    ye = _group.all_to_all(ye, group, 1, 0)                 # (E, C, d)
    y = _combine(ye, gtable, slots).reshape(Bl, Sl, d)
    return maybe_shard(y, specs.hid, mesh, x_spec), aux


def moe_apply(p: MoE, x: torch.Tensor, cfg, *, specs=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d), aux_loss). x: (B, S, d); on a mesh
    (``specs.mesh``) the rank's block in ``specs.hid``, and so is y."""
    B, S, d = x.shape
    mesh = None if specs is None else specs.mesh
    if mesh is None:
        y, aux = _moe_gather(p, x.reshape(B * S, d), cfg)
        y = y.reshape(B, S, d)
    elif _a2a_applicable(cfg, specs, full_dim(S, specs.hid[1], mesh)):
        y, aux = _moe_a2a(p, x, cfg, specs)
    else:
        xf = maybe_shard(x, P(), mesh, specs.hid)             # every token
        y, aux = _moe_gather(p, xf.reshape(-1, d), cfg)
        y = maybe_shard(y.reshape(xf.shape), specs.hid, mesh, P())
    if cfg.n_shared_experts:
        sh = _swiglu(torch.matmul(x, p.shared_wi.to(x.dtype)))
        y = y + torch.matmul(sh, p.shared_wo.to(x.dtype))
    return y, aux
