"""The port's other temporal mixers (``repro_torch.models.moe``, ``ssm``,
``rglru``) against the reference's on the CPU, unit by unit, with inputs
from numpy seeds.

* MoE: ``_route`` (gates, ids, counts and probability sums) and
  ``_dispatch_tables`` bitwise on a grid of T, E, k and capacity factors
  that drop and that do not; ``moe_apply``'s y and aux with and without
  shared experts, at capacity factors 0.5 (half the slots or more drop)
  and 1.25; no all-to-all schedule without a mesh.
* The chunked scans (``_ssm_scan_chunked``, ``_lru_scan_chunked``) with a
  chunk that does not divide S, one that does and one wider than S.
* ``_causal_conv`` with and without history, float32 and bf16.
* ``ssm_apply`` and ``rglru_apply`` in train, prefill and decode (eight
  steps through their caches).
* ``init_weights``' rules for the new parameters: ``A_log`` exact,
  ``D`` ones, ``lam`` 0.65, ``conv_w`` 0.1 N(0, 1) and the experts'
  ``wi``/``wo`` 0.02 N(0, 1) by their moments.

Tolerances: float32 results within ``TOL`` (2e-4; the scans sum in
another order than XLA's tree), bf16 within 1e-2.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_common import TOL, _np, _t
from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.models.transformer import ActSpecs
from repro_torch.configs import get_config
from repro_torch.models import moe, rglru, ssm, transformer

torch.set_num_threads(1)

BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _load(module: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Copy a reference param dict (unstacked) into ``module``."""
    for name, a in params.items():
        getattr(module, name).data.copy_(_t(a))
    assert set(dict(module.named_parameters())) == set(params)
    return module


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,k,dtype", [(12, 4, 2, "float32"),
                                         (33, 16, 3, "float32"),
                                         (8, 8, 1, "float32"),
                                         (12, 8, 2, "bfloat16")])
def test_route_matches_reference(T, E, k, dtype):
    rng = np.random.default_rng(T + E + k)
    xt = rng.standard_normal((T, 24)).astype(np.float32)
    router = rng.standard_normal((24, E)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = ref_moe._route(jnp.asarray(xt).astype(jdt), jnp.asarray(router),
                          E, k)
    got = moe._route(_t(xt).to(tdt), _t(router), E, k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    for g, w in ((got[0], want[0]), (got[3], want[3])):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _routing(T, E, k, seed):
    """tests/test_moe_dispatch.py's routing: random probabilities, the
    reference's top-k."""
    rng = np.random.default_rng(seed)
    probs = rng.random((T, E)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    gv, ei = jax.lax.top_k(jnp.asarray(probs), k)
    gv = gv / jnp.sum(gv, axis=-1, keepdims=True)
    counts = jnp.zeros((E,), jnp.float32).at[ei.reshape(-1)].add(1.0)
    return gv, ei, counts


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("E,k", [(2, 1), (8, 2), (16, 3)])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_dispatch_tables_equal_reference(T, E, k, cf):
    """The (E, C) token table and gate table bitwise, drops included."""
    gv, ei, counts = _routing(T, E, k, seed=T * 31 + E * 7 + k)
    C = max(1, int(T * k / E * cf))
    want_t, want_g = ref_moe._dispatch_tables(ei, gv, counts, E, C, T)
    got_t, got_g = moe._dispatch_tables(_t(ei).long(), _t(gv), _t(counts),
                                        E, C, T)
    assert got_t.shape == got_g.shape == (E, C)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    kept = int((got_t != T).sum())
    assert kept <= T * k and (kept == T * k or C < T * k)


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b"])
def test_moe_apply_matches_reference(arch, cf):
    """phi3.5's experts alone, deepseek's with 2 shared experts; at a
    capacity factor of 0.5 half the slots or more drop."""
    rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                               capacity_factor=cf)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              capacity_factor=cf)
    p, _ = ref_moe.moe_init(jax.random.key(4), rcfg)
    port = _load(moe.MoE(cfg, "cpu"), p)
    assert hasattr(port, "shared_wi") == bool(cfg.n_shared_experts)
    x = np.random.default_rng(8).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    want_y, want_aux = ref_moe.moe_apply(p, jnp.asarray(x), rcfg)
    got_y, got_aux = moe.moe_apply(port, _t(x), cfg)
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


@pytest.mark.parametrize("impl", ["a2a", "gather"])
def test_a2a_not_applicable_without_a_mesh(impl):
    """Without a mesh neither side takes the all-to-all schedule, so
    ``moe_impl="a2a"`` (the configs' default) runs the gather path."""
    rcfg = dataclasses.replace(ref_config("phi3.5-moe-42b-a6.6b",
                                          smoke=True), moe_impl=impl)
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b", smoke=True),
                              moe_impl=impl)
    for S in (1, 12):
        assert moe._a2a_applicable(cfg, None, S) is False
        assert ref_moe._a2a_applicable(rcfg, ActSpecs(), S) is False


# --------------------------------------------------------------------------
# the scans and the conv
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [5, 13, 16])
@pytest.mark.parametrize("which", ["ssm", "lru"])
def test_scan_chunked_matches_reference(which, chunk):
    """S=13: a chunk of 5 pads the last chunk by 2; 13 is one chunk; 16
    is cut to S. a in (0, 1), some near 0 (exp(dt A) underflowing)."""
    rng = np.random.default_rng(9)
    shape = (2, 13, 6, 4) if which == "ssm" else (2, 13, 10)
    a = np.exp(-rng.exponential(1.0, shape) * rng.choice(
        [0.1, 1.0, 200.0], shape)).astype(np.float32)
    bx = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal(shape[:1] + shape[2:]).astype(np.float32)
    ref_fn = ref_ssm._ssm_scan_chunked if which == "ssm" \
        else ref_rglru._lru_scan_chunked
    fn = ssm._ssm_scan_chunked if which == "ssm" else rglru._lru_scan_chunked
    want_hs, want_h = ref_fn(jnp.asarray(a), jnp.asarray(bx),
                             jnp.asarray(h0), chunk)
    got_hs, got_h = fn(_t(a), _t(bx), _t(h0), chunk)
    assert got_hs.shape == shape
    np.testing.assert_allclose(_np(got_hs), np.asarray(want_hs), **TOL)
    np.testing.assert_allclose(_np(got_h), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_reference(history, dtype):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = ref_ssm._causal_conv(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
        jnp.asarray(hist).astype(jdt) if history else None)
    got = ssm._causal_conv(_t(x).to(tdt), _t(w).to(tdt),
                           _t(hist).to(tdt) if history else None)
    assert got.dtype == tdt and got.shape == x.shape
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------
# ssm_apply and rglru_apply in every mode
# --------------------------------------------------------------------------


MIXERS = {
    "ssm": ("falcon-mamba-7b", ref_ssm.ssm_init, ref_ssm.ssm_apply,
            ref_ssm.init_ssm_cache, ssm.SSM, ssm.ssm_apply,
            ssm.init_ssm_cache),
    "rglru": ("recurrentgemma-2b", ref_rglru.rglru_init,
              ref_rglru.rglru_apply, ref_rglru.init_rglru_cache,
              rglru.RGLRU, rglru.rglru_apply, rglru.init_rglru_cache),
}


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_apply_matches_reference(mixer, mode):
    """train and prefill on 13 tokens (scan_chunk 8: a padded last
    chunk); decode 8 steps through the cache, output and cache leaves
    within TOL every step, the length advancing on the cache's device."""
    arch, r_init, r_apply, r_cache, cls, apply, make_cache = MIXERS[mixer]
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    p, _ = r_init(jax.random.key(5), rcfg)
    port = _load(cls(cfg, "cpu"), p)
    rng = np.random.default_rng(12)
    if mode != "decode":
        x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
        want, wc = r_apply(p, jnp.asarray(x), rcfg, mode=mode)
        got, gc = apply(port, _t(x), cfg, mode=mode)
        assert wc is None and gc is None
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        return
    rc = r_cache(rcfg, 2, jnp.float32)
    tc = make_cache(cfg, 2, torch.float32, "cpu")
    conv, h = tc.conv, tc.h
    for _ in range(8):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, rc = r_apply(p, jnp.asarray(x), rcfg, mode="decode", cache=rc)
        got, tc = apply(port, _t(x), cfg, mode="decode", cache=tc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        for g, w in zip(tc, rc):
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                       **TOL)
    # the conv window and the state are written in place
    assert tc.conv is conv and tc.h is h
    assert tc.length.dtype == torch.int32 and int(tc.length) == 8


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _normal_moments(w: torch.Tensor, sd: float, name: str) -> None:
    w = w.detach().double()
    n = w.numel()
    assert abs(float(w.mean())) < 6 * sd / n ** 0.5, name
    assert abs(float(w.std()) / sd - 1) < 6 / (2 * n) ** 0.5, name
    # not truncated: a normal of n >= 1000 draws reaches past 2 sd
    assert float(w.abs().max()) > 2.5 * sd, name


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "deepseek-v2-236b"])
def test_init_weights_new_parameter_rules(arch):
    """A_log = log(1 + arange(n)) exactly (within one ulp of the
    reference's XLA log), D ones, lam 0.65, conv_w 0.1 N(0, 1), the
    experts' wi and wo 0.02 N(0, 1); the router stays truncated."""
    cfg = get_config(arch, smoke=True)
    model = transformer.init_model(torch.Generator().manual_seed(2), cfg,
                                   device="cpu")
    seen = set()
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if leaf == "A_log":
            n = cfg.ssm_state
            want = np.log1p(np.arange(n, dtype=np.float64)).astype(np.float32)
            np.testing.assert_array_equal(p.numpy(),
                                          np.broadcast_to(want, p.shape))
            ref = np.asarray(jnp.log(1.0 + jnp.arange(n, dtype=jnp.float32)))
            np.testing.assert_array_max_ulp(p.numpy()[0], ref, maxulp=1)
        elif leaf == "D":
            assert torch.equal(p, torch.ones_like(p)), name
        elif leaf == "lam":
            assert torch.equal(p, torch.full_like(p, 0.65)), name
        elif leaf == "conv_w":
            _normal_moments(p, 0.1, name)
        elif name.endswith(("moe.wi", "moe.wo")):
            assert p.dim() == 3
            _normal_moments(p, 0.02, name)
        elif leaf == "router":
            scale = 1.0 / p.shape[0] ** 0.5
            assert float(p.abs().max()) <= 2.0 * scale * (1 + 1e-6), name
        else:
            continue
        seen.add(leaf if not name.endswith(("moe.wi", "moe.wo")) else
                 "moe." + leaf)
    want = {"falcon-mamba-7b": {"A_log", "D", "conv_w"},
            "recurrentgemma-2b": {"lam", "conv_w"},
            "deepseek-v2-236b": {"moe.wi", "moe.wo", "router"}}[arch]
    assert seen == want
