"""Rank functions of the LM-on-a-mesh tests (``test_torch_lm_mesh.py``),
run by ``repro_torch.parallel.spawn`` in processes of their own.
JAX-free: every rank imports this module.

Each function runs on every rank of a (data, model) mesh of the group
and returns numpy arrays and plain values (the whole tensors, gathered
from the ranks' slices, where the parent compares them with the
unsharded port and the reference).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch import parallel
from repro_torch.configs import get_config
from repro_torch.interop import reference_leaves
from repro_torch.models import init_caches, lm, transformer
from repro_torch.models.modules import P, maybe_shard, sp_out_proj, tree_map
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import _compress_int8
from repro_torch.parallel import group as group_lib
from repro_torch.parallel import mesh as pmesh

AXES = ("data", "model")


def config(arch: str, **kw):
    """The smoke config of ``arch``; an MoE at the capacity where nothing
    drops (E / top_k), so the a2a dispatch computes the gather's
    function."""
    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        kw.setdefault("capacity_factor", cfg.n_experts / cfg.top_k)
    return dataclasses.replace(cfg, **kw)


def sharded(cfg, seed: int, mesh, mode: str) -> transformer.LM:
    """The model of ``init_model(seed, cfg)`` on ``mesh``: this rank's
    slice of every parameter. (The ranks draw the weights themselves: a
    spawn's arguments reach its processes slowly.)"""
    model = transformer.init_model(seed, cfg, device="cpu")
    pbytes = 2 * sum(p.numel() for p in model.parameters())
    pspecs = pmesh.resolve_param_specs(
        transformer.param_specs(model), dict(model.named_parameters()),
        mesh, mode=mode, param_bytes=pbytes)
    return parallel.shard_model(model, mesh, pspecs)


def _parts(leaf) -> list:
    return leaf if isinstance(leaf, list) else [leaf]


def _whole(model, mesh) -> dict:
    layout = model.mesh_layout
    return {n: parallel.gather_tensor(p.detach(), layout[n].spec,
                                      mesh).numpy()
            for n, p in model.named_parameters()}


def _leaf_whole(model, cfg, tree: dict, mesh) -> dict:
    """Optimizer leaves (``reference_leaves``' form, the rank's slices) as
    the whole tensors, by parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for path, leaf in reference_leaves(model, cfg).items():
        parts = leaf if isinstance(leaf, list) else [leaf]
        vals = tree[path] if isinstance(leaf, list) else [tree[path]]
        for p, v in zip(parts, vals):
            n = names[id(p)]
            out[n] = parallel.gather_tensor(
                v, model.mesh_layout[n].spec, mesh).numpy()
    return out


def _counts() -> dict:
    return {g: {k: v for k, v in parallel.collective_counts(g).items() if v}
            for g in (None, "data", "model", "world")}


def train_case(arch: str, seed: int, batch: dict, with_steps: bool
               ) -> dict:
    """On a (4, 2) mesh: the sharded loss and gradients (whole); with
    ``with_steps``, also one ``make_train_step`` under each compression
    (the new weights and moments, whole), the ranks' local shapes of
    every parameter and moment, and the int8 compression of the sharded
    gradients against the unsharded compression of their whole."""
    mesh = parallel.make_mesh((4, 2), AXES)
    cfg = config(arch)
    model = sharded(cfg, seed, mesh, "train")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    B, S = batch["tokens"].shape
    specs = pmesh.act_specs(mesh, seq_len=S - 1, batch=B, mode="train")
    parallel.reset_collective_counts()
    loss, metrics, grads = lm.loss_and_grads(model, tb, cfg, 0.01, specs)
    out = dict(coords=mesh.coords, loss=float(loss), counts=_counts(),
               metrics={k: float(v) for k, v in metrics.items()},
               grads={n: parallel.gather_tensor(
                   g, model.mesh_layout[n].spec, mesh).numpy()
                   for n, g in grads.items()})
    if not with_steps:
        return out
    out["local"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out["full"] = {n: s.shape for n, s in model.mesh_layout.items()}
    out["wq"] = model.layers[0].attn.wq.detach().numpy().copy()
    whole = parallel.unshard_model(copy.deepcopy(model), mesh)
    fresh = transformer.init_model(seed, cfg, device="cpu")
    out["unshard_equal"] = not hasattr(whole, "mesh_layout") and all(
        torch.equal(a, b) for a, b in zip(whole.parameters(),
                                          fresh.parameters()))
    # int8 of the rank's slices against the unsharded int8 of the whole
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = reference_leaves(model, cfg)

    def per_leaf(of):
        return {path: [of(names[id(p)]) for p in leaf]
                if isinstance(leaf, list) else of(names[id(leaf)])
                for path, leaf in leaves.items()}

    g_local = per_leaf(grads.__getitem__)
    g_whole = per_leaf(lambda n: torch.from_numpy(out["grads"][n]))
    shardings = per_leaf(model.mesh_layout.__getitem__)
    deq = _compress_int8(g_local, 1, mesh, shardings)
    want = _compress_int8(g_whole, 1)
    out["int8_bitwise"] = all(
        torch.equal(parallel.gather_tensor(a, sh.spec, mesh), b)
        for path in deq
        for a, b, sh in zip(_parts(deq[path]), _parts(want[path]),
                            _parts(shardings[path])))
    out["steps"] = {}
    for compress in ("none", "int8"):
        m = copy.deepcopy(model)
        opt = AdamW(lr=1e-3, grad_compress=compress)
        st = opt.init(reference_leaves(m, cfg))
        m, st, met = lm.make_train_step(cfg, opt, specs)(m, st, tb)
        out["steps"][compress] = dict(
            loss=float(met["loss"]), params=_whole(m, mesh),
            m=_leaf_whole(m, cfg, st["m"], mesh),
            v=_leaf_whole(m, cfg, st["v"], mesh),
            local_m={n: tuple(t.shape) for n, t in _leaf_local(
                m, cfg, st["m"]).items()})
    return out


def _leaf_local(model, cfg, tree: dict) -> dict:
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for path, leaf in reference_leaves(model, cfg).items():
        parts = leaf if isinstance(leaf, list) else [leaf]
        vals = tree[path] if isinstance(leaf, list) else [tree[path]]
        out.update({names[id(p)]: v for p, v in zip(parts, vals)})
    return out


def decode_case(arch: str, seed: int, prompt: np.ndarray, new: int
                ) -> dict:
    """On a (4, 2) mesh in serve mode: the prefill's last logits (and the
    size of the last payload it all-gathered), and the tokens of
    ``greedy_generate``'s loop (the prompt teacher-forced through the
    decode step, then ``new`` greedy tokens) with the caches stored as
    ``layer_cache_specs`` says."""
    mesh = parallel.make_mesh((4, 2), AXES)
    cfg = config(arch)
    model = sharded(cfg, seed, mesh, "serve")
    B, S = prompt.shape
    tok_all = torch.from_numpy(prompt)
    pre = pmesh.act_specs(mesh, seq_len=S, batch=B, mode="prefill")
    # the payloads prefill all-gathers, the logits' the last
    sizes, real = [], group_lib.all_gather
    group_lib.all_gather = lambda x, *a: sizes.append(x.numel()) or real(
        x, *a)
    try:
        last = lm.make_prefill_step(cfg, pre)(model, {"tokens": tok_all})
    finally:
        group_lib.all_gather = real
    specs = pmesh.act_specs(mesh, seq_len=1, batch=B, mode="decode")
    caches = init_caches(cfg, B, S + new, "cpu")
    cspecs = pmesh.layer_cache_specs(cfg, caches, mesh)
    caches = tree_map(lambda t, s: parallel.shard_tensor(t, s, mesh),
                      caches, cspecs)
    local = [tuple(tuple(t.shape) for t in c) for c in caches]
    decode = lm.make_decode_step(cfg, specs, cspecs)
    tok, out = tok_all[:, :1], [tok_all[:, :1]]
    for i in range(S + new - 1):
        nxt, caches = decode(model, {"tokens": tok}, caches)
        tok = tok_all[:, i + 1:i + 2] if i + 1 < S else nxt[:, None]
        out.append(tok)
    return dict(prefill=last.numpy(), tokens=torch.cat(out, 1).numpy(),
                local_caches=local, cache_specs=cspecs,
                prefill_gathered=sizes[-1])


def mesh42_cases(train: list, decode: list) -> tuple[list, list]:
    """``train_case`` of each train case, then ``decode_case`` of each
    decode case, in one group."""
    return [train_case(*c) for c in train], [decode_case(*c) for c in decode]


# --------------------------------------------------------------------------
# the (2, 2) mesh: the MoE dispatches, sp_out_proj
# --------------------------------------------------------------------------


def moe_case(p: dict, x: np.ndarray, cfg_kw: dict) -> dict:
    """moe_apply on a (2, 2) mesh under the train specs, the tokens split
    over (data, model): y (whole), aux, and the gradients of sum(y^2) +
    0.01 aux with respect to the whole weights every rank holds (summed
    and the input x (summed over the ranks), and the collectives of the
    forward and backward."""
    mesh = parallel.make_mesh((2, 2), AXES)
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b", smoke=True),
                              **cfg_kw)
    mod = MoE(cfg, "cpu")
    with torch.no_grad():
        for n, t in mod.named_parameters():
            t.copy_(torch.from_numpy(p[n]))
            t.requires_grad_(True)
    B, S, _ = x.shape
    specs = pmesh.act_specs(mesh, seq_len=S, batch=B, mode="train")
    x_leaf = torch.from_numpy(x).requires_grad_()
    xl = maybe_shard(x_leaf, specs.hid, mesh)
    parallel.reset_collective_counts()
    y, aux = moe_apply(mod, xl, cfg, specs=specs)
    world = 4
    share = (y * y).sum() + 0.01 * aux / world
    names = [n for n, _ in mod.named_parameters()] + ["x"]
    wrt = [t for _, t in mod.named_parameters()] + [x_leaf]
    grads = parallel.all_reduce_sum(*torch.autograd.grad(share, wrt))
    counts = _counts()
    return dict(y=maybe_shard(y.detach(), P(), mesh, specs.hid).numpy(),
                aux=float(aux.detach()), counts=counts,
                grads={n: g.numpy() for n, g in zip(names, grads)})


def sp_case(h: np.ndarray, w: np.ndarray) -> dict:
    """sp_out_proj on a (2, 2) mesh: h the rank's batch block with the
    whole sequence, w whole and as the rank's rows; the result (whole)
    and the reduce-scatters it made."""
    mesh = parallel.make_mesh((2, 2), AXES)
    B, S, f = h.shape
    specs = pmesh.act_specs(mesh, seq_len=S, batch=B, mode="train")
    hid = transformer.stream_specs(specs, (B, S, w.shape[1])).hid
    hl = maybe_shard(torch.from_numpy(h), P("data"), mesh)
    wt = torch.from_numpy(w)
    r, c = mesh.axis_index("model"), f // 2
    out = {}
    for form, ww in (("whole", wt), ("rows", wt[r * c:(r + 1) * c])):
        parallel.reset_collective_counts()
        y = sp_out_proj(hl, ww, specs, hid, P("data"))
        out[form] = (maybe_shard(y, P(), mesh, hid).numpy(),
                     parallel.collective_counts()["reduce_scatter"])
    return out


def mesh22_cases(moe_in: list, sp_in: list) -> dict:
    return dict(moe=[moe_case(*c) for c in moe_in],
                sp=[sp_case(*c) for c in sp_in])
