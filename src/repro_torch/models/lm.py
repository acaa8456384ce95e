"""Training and serving steps and the loss built on
``transformer.model_apply``.

The counterpart of ``repro/models/lm.py``: ``make_train_step`` returns a
(model, opt_state, batch) -> (model, opt_state, metrics) step (autograd
through the differentiable bf16 cast of ``cast_params``, the layers
rematerialised as ``cfg.remat`` asks, ``cfg.micro_batches`` slices);
``make_prefill_step`` and ``make_decode_step`` return (model, batch[,
caches]) -> ... functions that run under ``torch.inference_mode``;
``greedy_generate`` is the reference's end-to-end loop.

Each step takes ``specs`` (``ActSpecs``; default none, the single-device
path). With a mesh (``specs.mesh``, a ``parallel.Mesh``) every rank runs
the step on the same whole batch and its slices of the model
(``parallel.shard_model``) and of the optimizer state: the loss sums the
rank's block of tokens over the global token count, each term divided
by the ranks that hold the same tokens, so the ranks' gradients add up
to the whole batch's; a parameter's gradient is reduce-scattered by the
backward of its gather and all-reduced over the ranks that hold a copy.
The metrics, the next tokens and the last-position logits are the whole
batch's on every rank.
"""
from __future__ import annotations

import copy
import math

import torch

from repro_torch.parallel import group as _group

from .modules import P, full_dim, maybe_shard
from .transformer import (ActSpecs, init_caches, model_apply, stream_specs)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked CE over the real (unpadded) vocab; labels < 0 or >= vocab
    are ignored. Returns (summed nll, n_tokens). logits float32 (B, S,
    Vp)."""
    Vp = logits.shape[-1]
    mask = (labels >= 0) & (labels < vocab)
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    # mask padded vocab slots
    pad_bias = torch.where(torch.arange(Vp, device=logits.device) < vocab,
                           0.0, -1e30).to(logits.dtype)
    logits = logits + pad_bias[None, None, :]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def cast_params(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """The bf16 compute copy of a model's float32 weights for a bf16
    config: ``model`` itself when the config is float32 or no weight is
    float32, else a copy with every float32 parameter cast to bf16 (the
    caller's model is left as it is).

    The cast is differentiable, as the reference's ``astype`` is under
    ``jax.grad``: in a train step, where the float32 masters require
    grad, the gradients of the bf16 copy reach them. Serving runs under
    ``torch.inference_mode``, so there it builds no graph."""
    if cfg.dtype != "bfloat16":
        return model
    # deepcopy takes each float32 parameter's bf16 cast from the memo, so
    # no second float32 copy of the weights is made on the way
    memo = {id(p): p.to(torch.bfloat16)
            for p in model.parameters() if p.dtype == torch.float32}
    if not memo:
        return model
    return copy.deepcopy(model, memo)


def lm_loss(model, batch, cfg, aux_weight: float = 0.01,
            specs: ActSpecs = ActSpecs()):
    """The reference's loss: next-token CE over the real vocab (pre-shifted
    ``labels`` when the batch has them), normalised by the batch's
    tokens, plus ``aux_weight`` times the MoE load-balance loss.

    On a mesh the first value is this rank's share, whose gradients the
    ranks add up (module docstring); ``metrics["loss"]`` is the loss."""
    model = cast_params(model, cfg)
    tokens = batch["tokens"]
    if "labels" in batch:
        inputs, labels = batch, batch["labels"]
    else:
        inputs = {**batch, "tokens": tokens[:, :-1]}
        labels = tokens[:, 1:]
    logits, aux, _ = model_apply(model, inputs, cfg, mode="train",
                                 specs=specs)
    mesh = specs.mesh
    if mesh is None:
        nll, n = cross_entropy(logits, labels, cfg.vocab)
        loss = nll / n.clamp_min(1).float() + aux_weight * aux
        return loss, {"nll": nll, "tokens": n, "aux": aux}
    hid = stream_specs(specs, (*labels.shape, cfg.d_model)).hid
    labels = maybe_shard(labels, P(hid[0], hid[1]), mesh)
    nll, n = cross_entropy(logits, labels, cfg.vocab)
    world = math.prod(mesh.shape)
    # the ranks holding one block of tokens (tp shares it without
    # sequence parallelism, dp when the batch does not split)
    rep = world * labels.numel() // math.prod(
        full_dim(m, e, mesh) for m, e in zip(labels.shape, hid))
    n_all, nll_all = _group.all_reduce_sum(n.float(), nll.detach())
    n_all, nll_all = n_all / rep, nll_all / rep
    share = nll / (n_all.clamp_min(1) * rep) + aux_weight * aux / world
    loss = nll_all / n_all.clamp_min(1) + aux_weight * aux.detach()
    return share, {"nll": nll_all, "tokens": n_all.to(n.dtype),
                   "aux": aux, "loss": loss}


def loss_and_grads(model, batch, cfg, aux_weight: float = 0.01,
                   specs: ActSpecs = ActSpecs()
                   ) -> tuple[torch.Tensor, dict, dict]:
    """``lm_loss`` and its gradient with respect to each of ``model``'s
    float32 parameters (``jax.value_and_grad``'s counterpart). Returns
    (loss, metrics, {name: float32 gradient}), all detached; a parameter
    the loss does not reach gets zeros. The parameters require grad for
    the call only. On a mesh each gradient is the rank's slice of the
    whole batch's (``model.mesh_layout``)."""
    named = list(model.named_parameters())
    flags = [p.requires_grad for _, p in named]
    for _, p in named:
        p.requires_grad_(True)
    try:
        loss, metrics = lm_loss(model, batch, cfg, aux_weight, specs)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    finally:
        for (_, p), f in zip(named, flags):
            p.requires_grad_(f)
    grads = {name: torch.zeros_like(p) if g is None else g
             for (name, p), g in zip(named, grads)}
    if specs.mesh is not None:
        loss = metrics.pop("loss")
        _reduce_replicas(grads, model.mesh_layout, specs.mesh)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _reduce_replicas(grads: dict, layout: dict, mesh) -> None:
    """Each gradient summed, in place, over the ranks that hold a copy of
    its slice (its replica axes), one all-reduce a set of axes."""
    by_axes: dict[tuple, list[str]] = {}
    for name in grads:
        axes = _group.replica_axes(layout[name].spec, mesh)
        if axes:
            by_axes.setdefault(axes, []).append(name)
    for axes, names in by_axes.items():
        summed = _group.all_reduce_sum(
            *(grads[n] for n in names), group=_group.axes_group(mesh, axes))
        for n, g in zip(names, summed if len(names) > 1 else (summed,)):
            grads[n] = g


def make_train_step(cfg, optimizer, specs: ActSpecs = ActSpecs(),
                    aux_weight: float = 0.01):
    """One optimizer step: ``train_step(model, opt_state, batch) ->
    (model, opt_state, metrics)``, the model's parameters updated in
    place; ``metrics`` holds ``loss``, ``nll``, ``tokens`` and ``aux``.

    ``cfg.micro_batches`` = k > 1 splits the batch into k slices along
    its first axis, as the reference's scan does: the slices' losses,
    metrics and gradients are summed, then the loss and the gradients
    multiplied by 1/k; ``nll``, ``tokens`` and ``aux`` stay sums, and
    each slice's loss is normalised by its own tokens. The optimizer
    takes the parameters as the reference's leaves
    (``interop.reference_leaves``), so its int8 scales and noise are the
    reference's a leaf. On a mesh (``specs.mesh``) the model and the
    optimizer state are the rank's slices and the optimizer is told
    their layout."""
    # imported here: interop imports the models
    from repro_torch.interop import reference_leaves

    k = max(1, cfg.micro_batches)

    def train_step(model, opt_state, batch):
        if k == 1:
            loss, metrics, grads = loss_and_grads(model, batch, cfg,
                                                  aux_weight, specs)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % k:
                raise ValueError(f"make_train_step: a batch of {B} does not "
                                 f"split into micro_batches={k} slices")
            b = B // k
            for j in range(k):
                mb = {n: x[j * b:(j + 1) * b] for n, x in batch.items()}
                out = loss_and_grads(model, mb, cfg, aux_weight, specs)
                if j == 0:
                    loss, metrics, grads = out
                    continue
                loss = loss + out[0]
                metrics = {n: metrics[n] + out[1][n] for n in metrics}
                for n, g in out[2].items():
                    grads[n].add_(g)
            inv = 1.0 / k
            loss = loss * inv
            grads = {n: g * inv for n, g in grads.items()}
        named = {id(p): n for n, p in model.named_parameters()}
        leaves = reference_leaves(model, cfg)

        def per_leaf(leaf, of):
            return [of(named[id(p)]) for p in leaf] \
                if isinstance(leaf, list) else of(named[id(leaf)])

        g_leaves = {path: per_leaf(leaf, grads.__getitem__)
                    for path, leaf in leaves.items()}
        kw = {}
        if specs.mesh is not None:
            layout = model.mesh_layout
            kw = dict(mesh=specs.mesh, shardings={
                path: per_leaf(leaf, layout.__getitem__)
                for path, leaf in leaves.items()})
        _, opt_state = optimizer.update(leaves, g_leaves, opt_state, **kw)
        return model, opt_state, dict(metrics, loss=loss)

    return train_step


def make_prefill_step(cfg, specs: ActSpecs = ActSpecs()):
    @torch.inference_mode()
    def prefill_step(model, batch):
        logits, _, _ = model_apply(cast_params(model, cfg), batch, cfg,
                                   mode="prefill", specs=specs)
        if specs.mesh is not None:
            # the last position of every rank's block -> the whole batch's
            # (a sequence split over tp is gathered first: its last
            # position lies on one rank)
            B, S = batch["tokens"].shape
            hid = stream_specs(specs, (B, S, cfg.d_model)).hid
            if hid[1] is not None:
                logits = maybe_shard(logits, P(hid[0]), specs.mesh, hid)
            logits = maybe_shard(logits[:, -1:], P(), specs.mesh,
                                 P(hid[0]))
        # only the last-position logits (next-token): the serving contract
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg, specs: ActSpecs = ActSpecs(), cache_specs=None):
    """``decode_step(model, batch, caches) -> (next tokens, caches)``. On
    a mesh the caches are stored as ``cache_specs`` (one a layer,
    ``parallel.mesh.layer_cache_specs``) says and the next tokens are the
    whole batch's."""
    @torch.inference_mode()
    def decode_step(model, batch, caches):
        logits, _, new_caches = model_apply(
            cast_params(model, cfg), batch, cfg, mode="decode",
            specs=specs, caches=caches, cache_specs=cache_specs)
        # the argmax runs over the padded vocab, as the reference's does
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        if specs.mesh is not None:
            B = batch["tokens"].shape[0]
            hid = stream_specs(specs, (B, 1, cfg.d_model)).hid
            next_tok = maybe_shard(next_tok, P(None), specs.mesh,
                                   P(hid[0]))
        return next_tok, new_caches

    return decode_step


@torch.inference_mode()
def greedy_generate(model, cfg, prompt: torch.Tensor, max_new: int):
    """End-to-end generation (teacher-forced prefill through the decode
    step, then greedy tokens)."""
    B, S = prompt.shape
    caches = init_caches(cfg, B, S + max_new, prompt.device)
    model = cast_params(model, cfg)
    decode = make_decode_step(cfg)
    tok = prompt[:, :1]
    out = [tok]
    for i in range(S + max_new - 1):
        nxt, caches = decode(model, {"tokens": tok}, caches)
        tok = prompt[:, i + 1:i + 2] if i + 1 < S else nxt[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
