"""The port's LM train step on the CPU: rematerialisation, micro-batches,
bf16 compute on float32 masters, every architecture's step, and serving
after training.

* Remat on equals remat off (loss and every gradient bitwise: the
  recompute is deterministic).
* ``cfg.micro_batches = 2``: the loss, metrics and gradients the
  optimizer receives equal the reference's ``make_train_step`` at k = 2
  (loss within 1e-5 relative, each leaf within 1e-4 of its max |g|).
* bf16 compute: the gradients reach the float32 masters in float32, and
  equal the reference's bf16 ones within BF16_GRAD_REL of each leaf's
  max |g| (the loss within 1e-3 relative).
* The counterpart of ``test_arch_smoke.py::test_forward_and_train_step``
  for the ten architectures: a finite loss, and the parameters moved.
* After a train step, ``greedy_generate`` equals a fresh model with the
  same weights, and no cache tensor requires grad.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_lm_common import (FWD, _batch, _inputs, _reference_params,
                              assert_grads_match, grad_tree)
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.interop import (_flatten, params_from_reference,
                                 reference_leaves, to_reference_tree)
from repro_torch.models import (greedy_generate, init_caches, init_model,
                                lm, make_decode_step, make_train_step,
                                model_apply, transformer)
from repro_torch.optim import AdamW

torch.set_num_threads(1)

BF16_GRAD_REL = 4e-2


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-2b",
                                  "whisper-large-v3", "phi3.5-moe-42b-a6.6b",
                                  "falcon-mamba-7b", "minicpm3-4b"])
def test_remat_on_equals_remat_off(arch):
    """The hybrid's superblock is one rematerialised unit and its tail
    blocks are not (recurrentgemma's smoke config has both)."""
    cfg = get_config(arch, smoke=True)
    model = init_model(1, cfg, device="cpu")
    batch = _batch(_inputs(cfg, seed=7), FWD, True)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = lm.loss_and_grads(model, batch, c)
    assert torch.equal(out[True][0], out[False][0])
    for name in out[True][2]:
        assert torch.equal(out[True][2][name], out[False][2][name]), name


class _RefCapture:
    """A reference optimizer that hands the step's gradients back."""

    def init(self, params):
        return {}

    def update(self, params, grads, state):
        return grads, state


class _PortCapture:
    """The port's counterpart: keeps the leaves' gradients."""

    def update(self, params, grads, state):
        self.grads = grads
        return params, state


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b",
                                  "whisper-large-v3"])
def test_micro_batches_match_reference_train_step(arch):
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), micro_batches=2)
    cfg = dataclasses.replace(get_config(arch, smoke=True), micro_batches=2)
    params, params_np = _reference_params(rcfg)
    model = params_from_reference(params_np, cfg, "cpu")
    rng = np.random.default_rng(9)
    x = {"tokens": rng.integers(0, cfg.vocab, (4, 10)).astype(np.int32)}
    if cfg.family == "encdec":
        x["frames"] = rng.standard_normal(
            (4, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    wg, _, wm = jax.jit(ref_lm.make_train_step(rcfg, _RefCapture()))(
        params, {}, _batch(x, FWD, False))
    cap = _PortCapture()
    _, _, gm = make_train_step(cfg, cap)(model, {}, _batch(x, FWD, True))
    for k in ("loss", "nll", "aux"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5,
                                   atol=1e-7)
    assert int(gm["tokens"]) == int(wm["tokens"]) == 4 * 9
    assert_grads_match(_flatten(to_reference_tree(cap.grads)),
                       _flatten(jax.tree.map(np.asarray, wg)))
    with pytest.raises(ValueError, match="micro_batches=2"):
        make_train_step(cfg, cap)(model, {}, _batch(
            {k: v[:3] for k, v in x.items()}, FWD, True))


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b"])
def test_bf16_gradients_reach_float32_masters(arch):
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params, params_np = _reference_params(rcfg)
    model = params_from_reference(params_np, cfg, "cpu")
    x = _inputs(cfg, seed=3)
    (want, _), wg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.lm_loss(p, b, rcfg, ref_tf.ActSpecs()),
        has_aux=True))(params, _batch(x, FWD, False))
    got, _, grads = lm.loss_and_grads(model, _batch(x, FWD, True), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    g, w = grad_tree(model, cfg, grads), _flatten(jax.tree.map(np.asarray, wg))
    for path in w:
        scale = float(np.abs(w[path]).max())
        assert scale > 0 and float(np.abs(g[path] - w[path]).max()) <= \
            BF16_GRAD_REL * scale, path


def _smoke_batch(cfg, B: int, S: int) -> dict:
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int64) + 3}
    if cfg.family == "encdec":
        batch["frames"] = torch.ones((B, cfg.enc_seq, cfg.d_model))
    if cfg.family == "vlm":
        batch["patches"] = torch.ones((B, cfg.stub_tokens, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_train_step(arch):
    cfg = get_config(arch, smoke=True)
    model = init_model(0, cfg, device="cpu")
    B, S = 2, 32
    batch = _smoke_batch(cfg, B, S)
    logits, aux, _ = model_apply(model, batch, cfg, mode="train")
    assert logits.shape[:2] == (B, S)
    assert bool(torch.isfinite(logits).all())

    before = [p.detach().clone() for p in model.parameters()]
    opt = AdamW(lr=1e-3)
    state = opt.init(reference_leaves(model, cfg))
    model, state, metrics = make_train_step(cfg, opt)(model, state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert sorted(metrics) == ["aux", "loss", "nll", "tokens"]
    assert any(float((a - b).abs().max()) > 0
               for a, b in zip(before, model.parameters()))
    assert int(state["step"]) == 1


def test_serving_after_training_builds_no_graph():
    cfg = get_config("smollm-135m", smoke=True)
    model = init_model(2, cfg, device="cpu")
    opt = AdamW(lr=1e-2)
    step = make_train_step(cfg, opt)
    state = opt.init(reference_leaves(model, cfg))
    model, state, _ = step(model, state, _smoke_batch(cfg, 2, 16))
    fresh = transformer.LM(cfg, "cpu")
    fresh.load_state_dict(model.state_dict())
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 5)))
    got = greedy_generate(model, cfg, prompt, 6)
    assert torch.equal(got, greedy_generate(fresh, cfg, prompt, 6))
    caches = init_caches(cfg, 2, 8, "cpu")
    decode = make_decode_step(cfg)
    tok = prompt[:, :1]
    for _ in range(4):
        tok, caches = decode(model, {"tokens": tok}, caches)
        tok = tok[:, None]
    assert not any(t.requires_grad for c in caches for t in c)
    assert not any(p.requires_grad for p in model.parameters())
    # and training goes on after serving
    _, state, metrics = step(model, state, _smoke_batch(cfg, 2, 16))
    assert int(state["step"]) == 2 and np.isfinite(float(metrics["loss"]))
