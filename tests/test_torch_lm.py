"""The port's LM substrate (``repro_torch.models``) against the reference
on the CPU, for the six architectures whose temporal mixer is attention.

* Units: ``rms_norm``, ``layer_norm``, ``rope`` (with ``rope_dim`` < hd),
  ``chunked_attention`` (causal, non-causal, windowed, a chunk that does
  not divide Sk, a query offset, MLA's narrower v), ``decode_attention``,
  ``_ring_decode`` before and after the ring wraps, ``cross_entropy`` with
  a padded vocab and ignored labels, a windowed GQA layer decoding
  through its ring cache.
* Whole models, each smoke config in float32 with the reference's
  weights carried over by ``params_from_reference``: the ``"train"``
  logits, ``make_prefill_step``'s last-position logits and 12
  teacher-forced decode steps (tokens equal, caches within tolerance,
  lengths equal) within ``TOL``; ``lm_loss``; ``greedy_generate``; one
  config in bf16 through ``make_prefill_step``.

The inputs come from numpy seeds; each architecture's reference results
are built once, in a module-scoped fixture.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_common import (B, TOL, _np, _t, build_case, check_bf16_prefill,
                              check_decode, check_greedy_generate,
                              check_loss, check_prefill, check_train)
from repro.configs import get_config as ref_config
from repro.models import attention as ref_attn
from repro.models import lm as ref_lm
from repro.models import modules as ref_mod
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.models import attention, lm, modules, transformer

torch.set_num_threads(1)

PORTED = ("smollm-135m", "granite-3-8b", "codeqwen1.5-7b", "minicpm3-4b",
          "whisper-large-v3", "internvl2-76b")


@pytest.fixture(scope="module", params=PORTED)
def case(request):
    """One architecture: the reference's results and the port's model on
    the same weights and inputs."""
    return build_case(request.param, seed=PORTED.index(request.param))


def test_train_logits_match_reference(case):
    check_train(case)


def test_prefill_last_logits_match_reference(case):
    check_prefill(case)


def test_decode_steps_match_reference(case):
    """12 teacher-forced decode steps: the tokens of every step equal, the
    caches (GQA k/v, MLA latent and rope) within TOL, lengths equal."""
    check_decode(case)


def test_lm_loss_matches_reference(case):
    check_loss(case)


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm3-4b"])
def test_greedy_generate_matches_reference_decode_loop(arch):
    """The prompt teacher-forced through the decode step, then greedy
    tokens. The reference's ``greedy_generate`` (and its serving CLI)
    takes ``jnp.where(i + 1 < S, prompt[:, i + 1:i + 2], ...)``, whose
    empty slice past the prompt broadcasts the next token to width 0 and
    raises at the first generated token (ROADMAP §3); the loop is run here
    with the reference's decode step and a Python branch instead."""
    check_greedy_generate(arch)


@pytest.mark.parametrize("arch", ["granite-3-8b", "minicpm3-4b"])
def test_bf16_prefill_matches_reference(arch):
    """bf16 through make_prefill_step (float32 weights cast by
    cast_params on both sides): within BF16_REL of max |logit|."""
    check_bf16_prefill(arch)


# --------------------------------------------------------------------------
# units
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else TOL
    jx, tx = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    got = modules.rms_norm(tx, _t(scale))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(
        ref_mod.rms_norm(jx, jnp.asarray(scale)), np.float32), **tol)
    for b in (None, bias):
        got = modules.layer_norm(tx, _t(scale), None if b is None else _t(b))
        want = ref_mod.layer_norm(jx, jnp.asarray(scale),
                                  None if b is None else jnp.asarray(b))
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **tol)


@pytest.mark.parametrize("shape,rope_dim", [((2, 7, 3, 16), None),
                                            ((2, 7, 3, 24), 8),
                                            ((2, 7, 8), None)])
def test_rope_matches_reference(shape, rope_dim):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = (np.arange(shape[1])[None, :] + np.array([[0], [5]])).astype(
        np.int32)
    got = modules.rope(_t(x), _t(pos), 10000.0, rope_dim)
    want = ref_mod.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, rope_dim)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    if rope_dim:
        np.testing.assert_array_equal(_np(got)[..., rope_dim:],
                                      x[..., rope_dim:])


# (Sq, Sk, KV, G, hd, hd_v, chunk, causal, q_offset, window)
ATTN_CASES = {
    "causal": (12, 12, 2, 2, 8, 8, 4, True, 0, 0),
    "non_causal": (12, 12, 2, 2, 8, 8, 4, False, 0, 0),
    "windowed": (12, 12, 1, 3, 8, 8, 4, True, 0, 5),
    "chunk_not_dividing": (13, 13, 2, 1, 8, 8, 5, True, 0, 0),
    "q_offset": (3, 10, 2, 2, 8, 8, 4, True, 7, 0),
    "mla_v_narrower": (9, 9, 4, 1, 12, 8, 4, True, 0, 0),
    "cross_unequal": (5, 11, 2, 2, 8, 8, 4, False, 0, 0),
}


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_chunked_attention_matches_reference(name):
    Sq, Sk, KV, G, hd, hd_v, chunk, causal, off, window = ATTN_CASES[name]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, Sq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, hd_v)).astype(np.float32)
    got = attention.chunked_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                      causal=causal, q_offset=off,
                                      window=window)
    want = ref_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), chunk=chunk,
                                      causal=causal, q_offset=off,
                                      window=window)
    assert got.shape == (2, Sq, KV, G, hd_v)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("length,window", [(1, 0), (6, 0), (10, 0), (9, 4)])
def test_decode_attention_matches_reference(length, window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 2, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    L = np.int32(length)
    got = attention.decode_attention(_t(q), _t(k), _t(v),
                                     torch.tensor(length, dtype=torch.int32),
                                     window)
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(L), window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("length", [1, 3, 4, 9])
def test_ring_decode_before_and_after_wrap(length):
    rng = np.random.default_rng(5)
    window = 4
    q = rng.standard_normal((2, 1, 1, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, window, 1, 8)).astype(np.float32)
    v = rng.standard_normal((2, window, 1, 8)).astype(np.float32)
    got = attention._ring_decode(_t(q), _t(k), _t(v),
                                 torch.tensor(length, dtype=torch.int32),
                                 window)
    want = ref_attn._ring_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(np.int32(length)),
                                 window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_windowed_gqa_decodes_through_its_ring_cache():
    """A GQA layer with a local window of 4 decoding 9 tokens: the ring
    cache wraps twice; outputs and caches as the reference's."""
    rcfg = ref_config("granite-3-8b", smoke=True)
    cfg = get_config("granite-3-8b", smoke=True)
    window = 4
    p, _ = ref_attn.gqa_init(jax.random.key(3), rcfg)
    port = attention.GQA(cfg, "cpu")
    for name, a in p.items():
        getattr(port, name).data.copy_(_t(a))
    rc = ref_attn.init_gqa_cache(rcfg, B, 16, jnp.float32, window=window)
    tc = attention.init_gqa_cache(cfg, B, 16, torch.float32, "cpu",
                                  window=window)
    assert tc.k.shape[1] == window
    xs = np.random.default_rng(6).standard_normal(
        (9, B, 1, cfg.d_model)).astype(np.float32)
    for i, x in enumerate(xs):
        pos = np.full((B, 1), i, np.int32)
        want, rc = ref_attn.gqa_apply(p, jnp.asarray(x), rcfg, mode="decode",
                                      positions=jnp.asarray(pos), cache=rc,
                                      window=window)
        got, tc = attention.gqa_apply(port, _t(x), cfg, mode="decode",
                                      positions=_t(pos), cache=tc,
                                      window=window)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(tc.k), np.asarray(rc.k), **TOL)
    np.testing.assert_allclose(_np(tc.v), np.asarray(rc.v), **TOL)
    assert int(tc.length) == int(rc.length) == 9


def test_cross_entropy_matches_reference():
    """vocab 300 padded to 512; labels < 0 and >= vocab are ignored."""
    rng = np.random.default_rng(7)
    vocab, Vp = 300, transformer.pad_vocab(300)
    assert Vp == ref_tf.pad_vocab(300) == 512
    logits = rng.standard_normal((2, 6, Vp)).astype(np.float32) * 4
    labels = rng.integers(0, vocab, (2, 6)).astype(np.int32)
    labels[0, 1], labels[1, 4], labels[1, 5] = -1, vocab, Vp - 1
    got, n = lm.cross_entropy(_t(logits), _t(labels).long(), vocab)
    want, wn = ref_lm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    vocab)
    assert int(n) == int(wn) == 9
    np.testing.assert_allclose(float(got), float(want), **TOL)
