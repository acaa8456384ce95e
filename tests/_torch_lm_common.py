"""Shared helpers of the LM substrate's parity tests (``test_torch_lm.py``,
``test_torch_lm_mixer_models.py``, ``test_torch_train*.py``): inputs
from numpy seeds, the reference's results on one architecture's smoke
config, and the checks that hold the port's model and its gradients to
them.

Not a test module (no ``test_`` prefix); it imports JAX, so no test
meant for the card imports it.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.interop import (_flatten, params_from_reference,
                                 reference_leaves, to_reference_tree)
from repro_torch.models import lm, transformer

TOL = dict(rtol=2e-4, atol=2e-4)
# float32 gradients: within this share of each reference leaf's max |g|
GRAD_REL = 1e-4
# bf16 logits: within this share of max |logit| of the reference's
BF16_REL = 2e-2
B, S, STEPS = 2, 12, 12
FWD = ("tokens", "frames", "patches")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _inputs(cfg, seed: int):
    """tokens, and frames / patches / enc_out where the family takes them."""
    rng = np.random.default_rng(seed)
    x = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        x["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        x["enc_out"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        x["patches"] = rng.standard_normal(
            (B, cfg.stub_tokens, cfg.d_model)).astype(np.float32)
    return x


def _batch(x: dict, keys, port: bool, tokens=None):
    out = {}
    for k in keys:
        if k in x:
            out[k] = x[k]
    if tokens is not None:
        out["tokens"] = tokens
    conv = (lambda a: _t(a).long() if a.dtype == np.int32 else _t(a)) \
        if port else jnp.asarray
    return {k: conv(np.asarray(v)) for k, v in out.items()}


def _reference_params(cfg):
    params, _ = ref_tf.init_model(jax.random.key(0), cfg)
    return params, jax.tree.map(np.asarray, params)


def build_case(arch: str, seed: int) -> dict:
    """One architecture's smoke config: the reference's train logits and
    aux, prefill logits, and STEPS teacher-forced decode steps (tokens,
    caches), and the port's model on the same weights and inputs."""
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params, params_np = _reference_params(rcfg)
    model = params_from_reference(params_np, cfg, "cpu")
    x = _inputs(cfg, seed=seed)
    ref = {}
    ref["train"], ref["aux"], _ = jax.jit(
        lambda p, b: ref_tf.model_apply(p, b, rcfg, mode="train"))(
            params, _batch(x, FWD, False))
    ref["prefill"] = jax.jit(ref_lm.make_prefill_step(rcfg))(
        params, _batch(x, FWD, False))
    step = jax.jit(ref_lm.make_decode_step(rcfg))
    caches = ref_tf.init_caches(rcfg, B, S + 1)
    toks = []
    for i in range(STEPS):
        tok, caches = step(params, _batch(x, ("enc_out",), False,
                                          x["tokens"][:, i:i + 1]), caches)
        toks.append(np.asarray(tok))
    ref["tokens"], ref["caches"] = np.stack(toks, 1), caches
    return dict(arch=arch, cfg=cfg, rcfg=rcfg, params=params,
                params_np=params_np, model=model, x=x, ref=ref)


def reference_cache_layers(caches, cfg) -> list[tuple]:
    """The reference's caches as the port's flat list, one tuple of numpy
    leaves a decoder layer in execution order: a stacked (L, ...) cache
    unstacked; the hybrid's (superblocks, tail), superblock j's position
    i at j * period + i, then the tail's."""
    def unstack(c, n):
        return [tuple(np.asarray(leaf)[j] for leaf in c) for j in range(n)]

    if cfg.family != "hybrid":
        return unstack(caches, cfg.n_layers)
    sup, tail = caches
    period = len(sup)
    n_super = cfg.n_layers // period
    per_pos = [unstack(c, n_super) for c in sup]
    out = [per_pos[i][j] for j in range(n_super) for i in range(period)]
    return out + [tuple(np.asarray(leaf) for leaf in c) for c in tail]


def check_train(case) -> None:
    cfg, x = case["cfg"], case["x"]
    got, aux, caches = transformer.model_apply(
        case["model"], _batch(x, FWD, True), cfg, mode="train")
    assert got.dtype == torch.float32 and caches is None
    assert got.shape == (B, S, transformer.pad_vocab(cfg.vocab))
    np.testing.assert_allclose(_np(got), np.asarray(case["ref"]["train"]),
                               **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    if cfg.n_experts:
        np.testing.assert_allclose(float(aux), float(case["ref"]["aux"]),
                                   **TOL)
    else:
        # no router, no aux term: exactly 0 on both sides
        assert float(aux) == 0.0 == float(case["ref"]["aux"])


def check_prefill(case) -> None:
    cfg, x = case["cfg"], case["x"]
    got = lm.make_prefill_step(cfg)(case["model"], _batch(x, FWD, True))
    assert got.shape == (B, transformer.pad_vocab(cfg.vocab))
    np.testing.assert_allclose(_np(got), np.asarray(case["ref"]["prefill"]),
                               **TOL)


def check_decode(case) -> None:
    """STEPS teacher-forced decode steps: the tokens of every step equal,
    every cache leaf within TOL, the int32 lengths equal."""
    cfg, x = case["cfg"], case["x"]
    step = lm.make_decode_step(cfg)
    caches = transformer.init_caches(cfg, B, S + 1, "cpu")
    toks = []
    for i in range(STEPS):
        tok, caches = step(case["model"],
                           _batch(x, ("enc_out",), True,
                                  x["tokens"][:, i:i + 1]), caches)
        toks.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(toks, 1), case["ref"]["tokens"])
    want = reference_cache_layers(case["ref"]["caches"], cfg)
    assert len(caches) == len(want) == cfg.n_layers
    for got_c, want_c in zip(caches, want):
        assert type(got_c)._fields[-1] == "length"
        assert len(got_c) == len(want_c)
        for g, w in zip(got_c[:-1], want_c[:-1]):
            assert g.shape == w.shape
            np.testing.assert_allclose(_np(g), w.astype(np.float32), **TOL)
        assert got_c.length.dtype == torch.int32
        assert int(got_c.length) == int(want_c[-1]) == STEPS


def check_loss(case) -> None:
    cfg, rcfg, x = case["cfg"], case["rcfg"], case["x"]
    want, wm = ref_lm.lm_loss(case["params"], _batch(x, FWD, False), rcfg,
                              ref_tf.ActSpecs())
    got, gm = lm.lm_loss(case["model"], _batch(x, FWD, True), cfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), **TOL)
    assert int(gm["tokens"]) == int(wm["tokens"]) == B * (S - 1)


def check_greedy_generate(arch: str) -> None:
    """The prompt teacher-forced through the decode step, then greedy
    tokens, against the reference's decode step under the same loop (the
    reference's own ``greedy_generate`` raises at the first generated
    token: ROADMAP §3)."""
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params, params_np = _reference_params(rcfg)
    model = params_from_reference(params_np, cfg, "cpu")
    Sp, new = 5, 6
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab, (B, Sp)).astype(np.int32)
    step = jax.jit(ref_lm.make_decode_step(rcfg))
    caches = ref_tf.init_caches(rcfg, B, Sp + new)
    tok = jnp.asarray(prompt[:, :1])
    want = [tok]
    for i in range(Sp + new - 1):
        nxt, caches = step(params, {"tokens": tok}, caches)
        tok = jnp.asarray(prompt[:, i + 1:i + 2]) if i + 1 < Sp \
            else nxt[:, None]
        want.append(tok)
    got = lm.greedy_generate(model, cfg, _t(prompt).long(), new)
    assert got.shape == (B, Sp + new)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, 1)))


def check_bf16_prefill(arch: str) -> None:
    """bf16 through make_prefill_step (float32 weights cast by
    cast_params on both sides): within BF16_REL of max |logit|."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params, params_np = _reference_params(rcfg)
    model = params_from_reference(params_np, cfg, "cpu")
    x = _inputs(cfg, seed=5)
    want = np.asarray(jax.jit(ref_lm.make_prefill_step(rcfg))(
        params, _batch(x, ("tokens",), False)))
    got = lm.make_prefill_step(cfg)(model, _batch(x, ("tokens",), True))
    assert got.dtype == torch.float32
    # cast_params leaves the caller's model in float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    scale = np.abs(want).max()
    assert np.abs(_np(got) - want).max() <= BF16_REL * scale


def grad_tree(model, cfg, grads: dict) -> dict:
    """The port's {name: gradient} as the reference's flat {path: array},
    a stacked leaf's layers stacked."""
    by_id = {id(p): grads[n] for n, p in model.named_parameters()}
    leaves = {path: [by_id[id(p)] for p in leaf] if isinstance(leaf, list)
              else by_id[id(leaf)]
              for path, leaf in reference_leaves(model, cfg).items()}
    return _flatten(to_reference_tree(leaves))


def assert_grads_match(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == np.float32, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale if scale else err == 0.0, \
            (path, err, scale)
