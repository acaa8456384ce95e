"""The port's models of the four architectures with the other temporal
mixers against the reference on the CPU: falcon-mamba-7b (ssm),
recurrentgemma-2b (the hybrid: a superblock of rec, rec, local attention
with window 8, then two tail rec blocks), phi3.5-moe-42b-a6.6b (MoE) and
deepseek-v2-236b (MLA + MoE with shared experts).

Each smoke config in float32 with the reference's weights carried over
by ``params_from_reference``: the ``"train"`` logits and aux loss,
``make_prefill_step``'s last-position logits, 12 teacher-forced decode
steps (tokens equal, every cache leaf within ``TOL``; the hybrid's ring
cache wraps at its window of 8), ``lm_loss`` with its aux term,
``greedy_generate``; falcon-mamba-7b and recurrentgemma-2b in bf16
through ``make_prefill_step`` (within ``BF16_REL``; the hybrid against
the reference run op by op) and teacher-forced decode against the
forward (the reference's ``test_decode_matches_prefill_logits``). The MoE configs' decode drops
more routed slots than their forward at the configs' capacity factor
(T = B at decode, ROADMAP §3), so their decode is held against the
forward at a capacity that drops nothing, and the gap at 1.25 is only
shown to exist.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_lm_common import (B, BF16_REL, S, TOL, _batch, _inputs, _np,
                              _reference_params, build_case, check_decode,
                              check_greedy_generate, check_loss,
                              check_prefill, check_train)
from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.interop import params_from_reference
from repro_torch.models import lm, model_apply, transformer

torch.set_num_threads(1)

MIXERS = ("falcon-mamba-7b", "recurrentgemma-2b", "phi3.5-moe-42b-a6.6b",
          "deepseek-v2-236b")
MOE = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")


@pytest.fixture(scope="module", params=MIXERS)
def case(request):
    """One architecture: the reference's results and the port's model on
    the same weights and inputs."""
    return build_case(request.param, seed=20 + MIXERS.index(request.param))


def test_train_logits_and_aux_match_reference(case):
    check_train(case)
    if case["cfg"].n_experts:
        assert float(case["ref"]["aux"]) > 0


def test_prefill_last_logits_match_reference(case):
    check_prefill(case)


def test_decode_steps_and_caches_match_reference(case):
    """12 steps: the hybrid's attention cache is a ring of 8 slots, so it
    wraps after 8; the first cache's length (a rec layer's for the
    hybrid) is every layer's."""
    cfg = case["cfg"]
    if cfg.family == "hybrid":
        caches = transformer.init_caches(cfg, B, S + 1, "cpu")
        kinds = [type(c).__name__ for c in caches]
        assert kinds == ["RGLRUCache", "RGLRUCache", "KVCache",
                         "RGLRUCache", "RGLRUCache"]
        assert caches[2].k.shape[1] == cfg.local_window == 8 < S
    check_decode(case)


def test_lm_loss_with_aux_matches_reference(case):
    check_loss(case)


@pytest.mark.parametrize("arch", MIXERS)
def test_greedy_generate_matches_reference_decode_loop(arch):
    check_greedy_generate(arch)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_bf16_prefill_matches_reference(arch):
    """bf16 through make_prefill_step (float32 weights cast by cast_params
    on both sides), within BF16_REL of max |logit| of the reference's bf16
    logits; and the port's bf16 logits differ from its own float32 ones by
    at least half the reference's bf16-against-float32 gap, so the port
    did round in bf16 (a float32 port sits about 1e-6 from them).

    recurrentgemma-2b is held against the reference run op by op
    (``jax.disable_jit``), as the port runs: under ``jit`` XLA fuses the
    reference's scanned superblocks and rounds their bf16 intermediates
    otherwise, which moves its logits 2.1% of max |logit| from its own
    op-by-op run on this input (1.3-2.8% over seeds 5-9). There the port
    is also nearer the reference's bf16 logits than its float32 ones."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params, params_np = _reference_params(rcfg)
    model = params_from_reference(params_np, cfg, "cpu")
    x = _inputs(cfg, seed=5)
    ref_batch, batch = _batch(x, ("tokens",), False), _batch(x, ("tokens",),
                                                             True)
    if cfg.family == "hybrid":
        with jax.disable_jit():
            want = np.asarray(ref_lm.make_prefill_step(rcfg)(params,
                                                             ref_batch))
    else:
        want = np.asarray(jax.jit(ref_lm.make_prefill_step(rcfg))(
            params, ref_batch))
    want32 = np.asarray(jax.jit(ref_lm.make_prefill_step(
        dataclasses.replace(rcfg, dtype="float32")))(params, ref_batch))
    got = _np(lm.make_prefill_step(cfg)(model, batch))
    got32 = _np(lm.make_prefill_step(
        dataclasses.replace(cfg, dtype="float32"))(model, batch))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err
    ref_gap = np.abs(want - want32).max()
    assert np.abs(got - got32).max() >= 0.5 * ref_gap
    if cfg.family == "hybrid":
        assert err < np.abs(got - want32).max()


def _decode_vs_forward(model, cfg, toks) -> tuple[np.ndarray, np.ndarray]:
    """The "train" forward's logits and S teacher-forced decode steps'."""
    fwd = model_apply(model, {"tokens": toks}, cfg, mode="train")[0]
    caches = transformer.init_caches(cfg, toks.shape[0], toks.shape[1] + 1,
                                     "cpu")
    dec = []
    for i in range(toks.shape[1]):
        lg, _, caches = model_apply(model, {"tokens": toks[:, i:i + 1]}, cfg,
                                    mode="decode", caches=caches)
        dec.append(lg[:, 0])
    return _np(fwd), _np(torch.stack(dec, 1))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_decode_matches_prefill_logits(arch):
    """The reference's test: teacher-forced decode gives the forward's
    last-position argmax; here every position's logits within TOL."""
    cfg = get_config(arch, smoke=True)
    model = transformer.init_model(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S)))
    fwd, dec = _decode_vs_forward(model, cfg, toks)
    np.testing.assert_allclose(dec, fwd, **TOL)
    np.testing.assert_array_equal(dec[:, -1].argmax(-1), fwd[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_at_a_capacity_that_drops_nothing(arch):
    """At capacity_factor = n_experts / top_k, C >= T at decode (T = B)
    and at the forward (T = B S), so no slot drops and decode gives the
    forward's logits; at the config's 1.25 decode's C is 1 (B = 2), so
    tokens routed to one expert drop and the two differ, in the
    reference as here."""
    base = get_config(arch, smoke=True)
    no_drop = dataclasses.replace(
        base, capacity_factor=base.n_experts / base.top_k)
    for T in (B, B * S):
        assert int(T * base.top_k / base.n_experts
                   * no_drop.capacity_factor) >= T
    params_np = _reference_params(ref_config(arch, smoke=True))[1]
    model = params_from_reference(params_np, base, "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, base.vocab, (B, S)))
    fwd, dec = _decode_vs_forward(model, no_drop, toks)
    np.testing.assert_allclose(dec, fwd, **TOL)
    fwd, dec = _decode_vs_forward(model, base, toks)
    assert np.abs(dec - fwd).max() > 1e-3
