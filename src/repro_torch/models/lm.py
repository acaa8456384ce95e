"""Serving steps and the loss built on ``transformer.model_apply``.

The counterpart of ``repro/models/lm.py``: ``make_prefill_step`` and
``make_decode_step`` return (model, batch[, caches]) -> ... functions;
``greedy_generate`` is the reference's end-to-end loop. Training
(``make_train_step``) is ROADMAP item 11b.
"""
from __future__ import annotations

import copy

import torch

from .transformer import init_caches, model_apply


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
    float32, else a copy with every float32 parameter in bf16 (the
    caller's model is left as it is)."""
    if cfg.dtype != "bfloat16":
        return model
    # deepcopy takes each float32 parameter's bf16 cast from the memo, so
    # no second float32 copy of the weights is made on the way
    memo = {id(p): torch.nn.Parameter(p.detach().to(torch.bfloat16),
                                      requires_grad=False)
            for p in model.parameters() if p.dtype == torch.float32}
    if not memo:
        return model
    return copy.deepcopy(model, memo)


def lm_loss(model, batch, cfg, aux_weight: float = 0.01):
    """The reference's loss, forward only: next-token CE over the real
    vocab (pre-shifted ``labels`` when the batch has them)."""
    model = cast_params(model, cfg)
    tokens = batch["tokens"]
    if "labels" in batch:
        inputs, labels = batch, batch["labels"]
    else:
        inputs = {**batch, "tokens": tokens[:, :-1]}
        labels = tokens[:, 1:]
    logits, aux, _ = model_apply(model, inputs, cfg, mode="train")
    nll, n = cross_entropy(logits, labels, cfg.vocab)
    loss = nll / n.clamp_min(1).float() + aux_weight * aux
    return loss, {"nll": nll, "tokens": n, "aux": aux}


def make_train_step(cfg, optimizer=None, aux_weight: float = 0.01):
    raise NotImplementedError(
        "make_train_step: training (autograd, the int8-compressed AdamW of "
        "optim/, launch/train.py) is not ported yet; it is ROADMAP item 11b")


def make_prefill_step(cfg):
    def prefill_step(model, batch):
        logits, _, _ = model_apply(cast_params(model, cfg), batch, cfg,
                                   mode="prefill")
        # only the last-position logits (next-token): the serving contract
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, batch, caches):
        logits, _, new_caches = model_apply(cast_params(model, cfg), batch,
                                            cfg, mode="decode", caches=caches)
        # the argmax runs over the padded vocab, as the reference's does
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        return next_tok, new_caches

    return decode_step


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
