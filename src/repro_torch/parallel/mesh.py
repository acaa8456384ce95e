"""Sharding-rule resolution for the LM on a mesh of H100s.

The counterpart of ``repro/parallel/mesh.py``. Every resolver takes a
mesh as anything with ``axis_names`` and ``shape``, the sizes by axis
name (a mapping) or in ``axis_names``' order (a tuple): a rank's
``parallel.Mesh`` and a shape-only ``MeshShape`` both qualify, so specs
resolve for meshes no process builds.

Sharding rules (the reference's):
  train  — FSDP: weights and optimizer state shard over (pod, data) x
           model; activations batch -> data (+pod), sequence -> model
           (sequence parallelism at block boundaries), TP on projections
           and experts.
  serve  — TP only; weights also shard over data when the per-card
           footprint passes ``SERVE_WEIGHT_BUDGET`` (inference-FSDP).

Every placement is checked for divisibility against the mesh: a dim that
does not divide falls back to replication for that dim (smollm's 9
heads never shard over model=2; its 576 flattened features do). The
reference's ``_axis_size`` and ``_fit`` are ``parallel.group``'s
``axes_size`` and ``fit_entry``, which ``maybe_shard`` also fits by.

``parallel.shard_model`` places a model on a mesh by its resolved specs
(the reference's ``named``).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any

from repro_torch.models.modules import FSDP, TP, P, tree_map
from repro_torch.models.transformer import ActSpecs
from repro_torch.parallel import group as _group

# One H100 SXM: 80 GB of HBM3. The serving weight budget keeps the
# reference's share of a card, 9/16 (9 GiB of a TPU v5e's 16), for the
# TP-sharded bf16 weights; the rest is headroom for the caches and the
# activations.
HBM_BYTES = 80 * 10**9
SERVE_WEIGHT_BUDGET = HBM_BYTES * 9 // 16


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process behind it."""

    shape: dict
    axis_names: tuple

    def axis_size(self, name: str) -> int:
        return int(self.shape[name])


def mesh_shape(sizes: tuple[int, ...], axis_names: tuple[str, ...]
               ) -> MeshShape:
    return MeshShape(dict(zip(axis_names, sizes)), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production meshes of H100 clusters, shape only (the
    counterpart of the reference's TPU pods (16, 16) and (2, 16, 16),
    whose names ``pod1`` and ``pod2`` the dry run keeps so that its
    records line up with the reference's): ``pod1`` is (32, 8) over
    ("data", "model"), 256 cards as 32 nodes of 8, tensor parallelism
    inside a node's NVLink domain; ``multi_pod`` gives ``pod2``, (2, 32,
    8) over ("pod", "data", "model"), 512 cards."""
    if multi_pod:
        return mesh_shape((2, 32, 8), ("pod", "data", "model"))
    return mesh_shape((32, 8), ("data", "model"))


def mesh_axes(mesh) -> dict[str, Any]:
    multi = "pod" in mesh.axis_names
    dp = ("pod", "data") if multi else ("data",)
    return {
        "dp": dp,
        "tp": "model",
        "dp_size": _group.axes_size(mesh, dp),
        "tp_size": _group.axes_size(mesh, "model"),
    }


def _resolve_leaf_spec(spec, shape, mesh, fsdp_axes, tp_axis) -> P:
    out = []
    for i, e in enumerate(spec):
        if e == FSDP:
            e = fsdp_axes
        elif e == TP:
            e = tp_axis
        if e is not None and i < len(shape):
            e = _group.fit_entry(e, shape[i], mesh)
        out.append(e)
    return P(*out)


def resolve_param_specs(spec_tree, shape_tree, mesh, *, mode: str,
                        param_bytes: int = 0):
    """Map FSDP/TP placeholders to mesh axes with divisibility fallback.
    ``spec_tree``: specs (e.g. ``transformer.param_specs``' {name: P});
    ``shape_tree``: the same tree of anything with ``.shape`` (tensors,
    meta tensors)."""
    ax = mesh_axes(mesh)
    if mode == "train":
        fsdp: Any = ax["dp"] if len(ax["dp"]) > 1 else ax["dp"][0]
    else:
        # inference-FSDP only when TP-sharded weights would pass the budget
        per_chip = param_bytes / ax["tp_size"]
        fsdp = (
            (ax["dp"] if len(ax["dp"]) > 1 else ax["dp"][0])
            if per_chip > SERVE_WEIGHT_BUDGET
            else None
        )

    def fix(spec, shape):
        return _resolve_leaf_spec(spec, tuple(shape.shape), mesh, fsdp, ax["tp"])

    return tree_map(fix, spec_tree, shape_tree)


def _stream(mesh, seq_len: int, batch: int, mode: str) -> tuple:
    """(the mesh's axes, the dp entry, the batch's entry, the sequence's
    entry) of the residual stream."""
    ax = mesh_axes(mesh)
    dp = ax["dp"] if len(ax["dp"]) > 1 else ax["dp"][0]
    bdim = dp if batch % ax["dp_size"] == 0 else None
    # sequence-parallel residual stream in train (bounds the remat carry)
    sp = (
        ax["tp"]
        if mode == "train" and seq_len % ax["tp_size"] == 0
        else None
    )
    return ax, dp, bdim, sp


def act_specs(mesh, *, seq_len: int, batch: int, mode: str) -> ActSpecs:
    ax, dp, bdim, sp = _stream(mesh, seq_len, batch, mode)
    return ActSpecs(hid=P(bdim, sp, None), mesh=mesh, dp=dp, tp=ax["tp"])


def reference_layouts(mesh, *, seq_len: int, batch: int, mode: str,
                      d_ff: int = 0) -> dict:
    """The reference's activation specs that the port's schedule does not
    take: its Megatron layouts ``feat`` (B, S, f), ``exp`` (E, C, d) and
    ``logits`` (B, S, V), and ``mlp_dp``, its choice of the ZeRO-3 MLP
    schedule (when the tokens a data shard holds outnumber 1.5 d_ff)."""
    ax, _, bdim, _ = _stream(mesh, seq_len, batch, mode)
    t_full = (batch // ax["dp_size"] if bdim else batch) * seq_len
    return dict(feat=P(bdim, None, ax["tp"]), exp=P(ax["tp"], bdim, None),
                logits=P(bdim, None, ax["tp"]),
                mlp_dp=d_ff > 0 and t_full > 1.5 * d_ff)


def batch_specs(batch_struct, mesh) -> Any:
    """tokens/labels (B, S) -> P(dp, None); embeddings (B, S, d) likewise."""
    ax = mesh_axes(mesh)
    dp = ax["dp"] if len(ax["dp"]) > 1 else ax["dp"][0]

    def fix(x):
        shape = tuple(x.shape)
        bdim = dp if shape and shape[0] % ax["dp_size"] == 0 else None
        return P(*([bdim] + [None] * (len(shape) - 1)))

    return tree_map(fix, batch_struct)


def cache_specs(cache_struct, mesh) -> Any:
    """Stacked caches (L, B, ..., D_last): batch -> dp, the innermost
    divisible of the last two dims -> model, the rest replicated."""
    ax = mesh_axes(mesh)
    dp = ax["dp"] if len(ax["dp"]) > 1 else ax["dp"][0]
    tp = ax["tp"]
    tp_n = ax["tp_size"]

    def fix(x):
        shape = tuple(x.shape)
        nd = len(shape)
        if nd <= 1:
            return P()
        spec = [None] * nd
        # batch axis: stacked caches have it at 1, unstacked at 0
        for b_ax in (1, 0):
            if b_ax < nd - 1 and shape[b_ax] % ax["dp_size"] == 0 and \
                    shape[b_ax] > 1:
                spec[b_ax] = dp
                break
        if shape[-1] % tp_n == 0:
            spec[-1] = tp
        elif nd >= 2 and shape[-2] % tp_n == 0 and spec[nd - 2] is None:
            spec[-2] = tp
        return P(*spec)

    return tree_map(fix, cache_struct)


def layer_cache_specs(cfg, caches, mesh) -> list:
    """The specs of the port's caches, one a decoder layer in execution
    order (``transformer.init_caches``): each leaf's spec is
    ``cache_specs``' for the reference's stacked leaf, (L, ...) over the
    layers of its stack (the hybrid's superblocks by pattern position;
    its tail unstacked), with the stack's entry dropped. Where the
    reference splits the stack axis over dp (a batch that does not
    divide), the port keeps every layer's cache on every rank of dp."""
    from repro_torch.models.transformer import _hybrid_layout

    if cfg.family == "hybrid":
        pat, n_super, _ = _hybrid_layout(cfg)
        stacked = [n_super] * (n_super * len(pat))
    else:
        stacked = [len(caches)] * len(caches)
    stacked += [None] * (len(caches) - len(stacked))

    def one(cache, L):
        if L is None:
            return cache_specs(cache, mesh)
        spec = cache_specs(tree_map(
            lambda t: types.SimpleNamespace(shape=(L, *t.shape)), cache),
            mesh)
        return tree_map(lambda s: P(*s[1:]), spec)

    return [one(c, L) for c, L in zip(caches, stacked)]


def resolve_shardings(cfg, shape_cfg, mesh):
    """One-stop: a cell's act specs, the reference's other layouts
    (``reference_layouts``) and the mesh's axes."""
    kw = dict(seq_len=shape_cfg.seq_len, batch=shape_cfg.global_batch,
              mode=shape_cfg.mode)
    return {
        "act": act_specs(mesh, **kw),
        "reference": reference_layouts(mesh, d_ff=cfg.d_ff, **kw),
        "axes": mesh_axes(mesh),
    }
