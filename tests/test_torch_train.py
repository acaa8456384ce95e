"""The port's LM optimizers, schedules, training checkpoints and training
CLI against the reference on the CPU.

* ``linear_warmup`` and ``cosine_schedule`` equal the reference's within
  one float32 ulp at every step from 0 to total + 5 (jitted, the
  reference moves by a few ulps: ROADMAP §3).
* One AdamW update on identical parameters and gradients (a stacked
  leaf among them) equals the reference's within 1e-6 relative, with
  and without weight decay and clipping, the clip's global norm
  accurate on an embedding-sized leaf; ``sgd_momentum`` likewise; both
  converge as the reference's tests ask (``test_substrates.py``).
* ``quantize_int8`` fed the reference's noise gives its q and scale
  bitwise on every leaf of a smoke model's gradient, the stacked ones
  quantized on one scale across their layers; the optimizer's int8 path
  keeps one scale a reference leaf.
* ``params_to_reference`` gives back the reference's param tree bitwise
  for the ten smoke configs; a checkpoint written by
  ``repro.launch.train`` resumes in ``repro_torch.launch.train`` and the
  reverse, the losses after the resume within 1e-5 relative, the two
  files holding the same leaves; the CLI wants a GPU by default.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_common import _batch, _inputs, _reference_params
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import train as ref_train
from repro.models import lm as ref_lm
from repro.models import transformer as ref_tf
from repro.optim import AdamW as RefAdamW
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import linear_warmup as ref_warmup
from repro.optim import sgd_momentum as ref_sgd
from repro_torch.configs import get_config
from repro_torch.interop import (_flatten, params_from_reference,
                                 params_to_reference, reference_leaves)
from repro_torch.launch import train
from repro_torch.optim import (AdamW, cosine_schedule, global_norm,
                               linear_warmup, quantize_int8, sgd_momentum)
from repro_torch.optim.adamw import _compress_int8

torch.set_num_threads(1)

L = 3  # layers of the stacked leaf of the optimizer cases


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------


SCHEDULES = [
    ("warmup", (3e-4, 10)), ("warmup", (1.0, 0)), ("warmup", (0.7, 1)),
    ("cosine", (3e-4, 20, 200, 0.1)), ("cosine", (1.0, 10, 100, 0.1)),
    ("cosine", (3e-4, 0, 4, 0.1)), ("cosine", (2.5e-3, 7, 7, 0.0)),
    ("cosine", (1e-3, 3, 50, 0.25))]


def _schedule_values(kind, args, jit: bool = False):
    """(port, reference) float32 values at steps 0 to total + 5; the
    reference's op by op, or jitted."""
    port, ref = {"warmup": (linear_warmup, ref_warmup),
                 "cosine": (cosine_schedule, ref_cosine)}[kind]
    total = args[2] if kind == "cosine" else 2 * args[1]
    f, g = port(*args), ref(*args)
    g = jax.jit(g) if jit else g
    got = np.array([float(f(torch.tensor(s, dtype=torch.int32)))
                    for s in range(total + 6)], np.float32)
    want = np.array([g(jnp.asarray(s, jnp.int32)) for s in range(total + 6)],
                    np.float32)
    assert float(f(total)) == got[total]  # an int step: the same value
    return got, want


@pytest.mark.parametrize("kind,args", SCHEDULES)
def test_schedules_match_reference_to_an_ulp(kind, args):
    got, want = _schedule_values(kind, args)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_jitted_reference_schedule_moves_by_ulps():
    """ROADMAP §3: under jax.jit XLA rewrites the reference's division by
    a constant as a product with its reciprocal and fuses the cosine, so
    the lr its jitted train step reads differs from the same function op
    by op (which the port equals) by a few float32 ulps."""
    worst = 0
    for kind, args in SCHEDULES:
        got, want = _schedule_values(kind, args, jit=True)
        d = np.abs(got.view(np.int32).astype(np.int64)
                   - want.view(np.int32).astype(np.int64))
        worst = max(worst, int(d.max()))
    assert 1 < worst <= 16
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_schedule_shapes():
    f = cosine_schedule(1.0, 10, 100)
    assert float(f(torch.tensor(0))) == 0.0
    assert float(f(torch.tensor(10))) == pytest.approx(1.0)
    assert float(f(torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)


# --------------------------------------------------------------------------
# AdamW and SGD
# --------------------------------------------------------------------------


def _opt_case(seed: int, scale: float):
    """Parameters {"a": a stacked (L, 4, 6) leaf, "b": (5,)} and three
    steps of gradients, as numpy."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((L, 4, 6)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _port_tree(tree: dict) -> dict:
    """The stacked leaf "a" as a list of its layers, as the port's
    optimizer takes a reference leaf."""
    return {"a": [torch.from_numpy(tree["a"][i].copy()) for i in range(L)],
            "b": torch.from_numpy(tree["b"].copy())}


def _stacked(tree: dict) -> dict:
    return {"a": np.stack([t.numpy() for t in tree["a"]]),
            "b": tree["b"].numpy()}


def _run_both(ref_opt, port_opt, params_np, grads_np):
    ref_p = jax.tree.map(jnp.asarray, params_np)
    ref_s = ref_opt.init(ref_p)
    update = jax.jit(ref_opt.update)
    port_p = _port_tree(params_np)
    port_s = port_opt.init(port_p)
    for g in grads_np:
        ref_p, ref_s = update(ref_p, jax.tree.map(jnp.asarray, g), ref_s)
        port_p, port_s = port_opt.update(port_p, _port_tree(g), port_s)
    return ref_p, ref_s, port_p, port_s


@pytest.mark.parametrize("weight_decay,clip_norm,grad_scale", [
    (0.1, 1.0, 1.0),      # clipped (|g| ~ 5)
    (0.0, 1.0, 1.0),
    (0.1, 1e3, 1.0),      # not clipped
    (0.0, 1e3, 1e-3)])
def test_adamw_update_matches_reference(weight_decay, clip_norm, grad_scale):
    params, grads = _opt_case(0, grad_scale)
    kw = dict(weight_decay=weight_decay, clip_norm=clip_norm)
    ref_p, ref_s, port_p, port_s = _run_both(
        RefAdamW(lr=ref_cosine(1e-2, 1, 10), **kw),
        AdamW(lr=cosine_schedule(1e-2, 1, 10), **kw), params, grads)
    for k in params:
        np.testing.assert_allclose(_stacked(port_p)[k], np.asarray(ref_p[k]),
                                   rtol=1e-6, atol=1e-7)
        for mom in ("m", "v"):
            got = _stacked(port_s[mom])[k]
            want = np.asarray(ref_s[mom][k])
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
            assert got.dtype == np.float32
    assert port_s["step"].dtype == torch.int32
    assert int(port_s["step"]) == int(ref_s["step"]) == 3


def test_global_norm_is_accurate_on_a_large_leaf():
    """The clip's global norm on a 2^24-element leaf (an embedding's size)
    within 1e-6 of the float64 norm and of the reference's: the CPU's
    float32 ``norm`` accumulates serially and is ~1e-3 off there."""
    x = np.random.default_rng(2).standard_normal(1 << 24).astype(
        np.float32) * 1e-3
    x64 = x.astype(np.float64)
    exact = float(np.sqrt(np.sum(x64 ** 2) + np.sum(x64[:5] ** 2)))
    got = float(global_norm({"e": torch.from_numpy(x), "f": [
        torch.from_numpy(x[:5])]}))
    want = float(ref_adamw.global_norm({"e": jnp.asarray(x),
                                        "f": jnp.asarray(x[:5])}))
    assert abs(got - exact) <= 1e-6 * exact
    assert abs(want - exact) <= 1e-6 * exact


def test_sgd_momentum_matches_reference():
    params, grads = _opt_case(1, 1.0)
    ref_p, ref_s, port_p, port_s = _run_both(
        ref_sgd(lr=0.05, momentum=0.9), sgd_momentum(lr=0.05, momentum=0.9),
        params, grads)
    for k in params:
        np.testing.assert_allclose(_stacked(port_p)[k], np.asarray(ref_p[k]),
                                   rtol=1e-6, atol=1e-7)
        want = np.asarray(ref_s["mom"][k])
        np.testing.assert_allclose(_stacked(port_s["mom"])[k], want,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert int(port_s["step"]) == int(ref_s["step"]) == 3


def _quadratic(opt, n: int, steps: int) -> torch.Tensor:
    params = {"w": torch.full((n,), 5.0)}
    state = opt.init(params)
    for _ in range(steps):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - 2.0) ** 2), w)
        params, state = opt.update(params, {"w": g}, state)
    return params["w"]


def test_adamw_converges_quadratic():
    w = _quadratic(AdamW(lr=0.1, weight_decay=0.0), 4, 300)
    np.testing.assert_allclose(w.numpy(), 2.0, atol=1e-2)


def test_int8_grad_compression_still_converges():
    w = _quadratic(AdamW(lr=0.1, weight_decay=0.0, grad_compress="int8"),
                   64, 400)
    np.testing.assert_allclose(w.numpy(), 2.0, atol=0.1)


# --------------------------------------------------------------------------
# int8 compression by reference leaf
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_grads():
    """The reference's gradient of smollm-135m's smoke config, and the
    port's model on the same weights."""
    rcfg, cfg = ref_config("smollm-135m", smoke=True), \
        get_config("smollm-135m", smoke=True)
    params, params_np = _reference_params(rcfg)
    x = _inputs(cfg, seed=4)
    (_, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.lm_loss(p, b, rcfg, ref_tf.ActSpecs()),
        has_aux=True))(params, _batch(x, ("tokens",), False))
    return grads, params_from_reference(params_np, cfg, "cpu"), cfg


def test_quantize_int8_matches_reference_bitwise_by_leaf(smoke_grads):
    grads, model, cfg = smoke_grads
    leaves = reference_leaves(model, cfg)
    ref_leaves, _ = jax.tree_util.tree_flatten_with_path(grads)
    # the port visits the reference's leaves in jax.tree's order
    assert [tuple(k.key for k in path) for path, _ in ref_leaves] == \
        list(leaves)
    assert any(isinstance(v, list) and len(v) == cfg.n_layers
               for v in leaves.values())
    step = 3
    key = jax.random.fold_in(jax.random.key(17), step)
    for i, ((path, g), leaf) in enumerate(zip(ref_leaves, leaves.values())):
        k = jax.random.fold_in(key, i)
        want_q, want_s = ref_adamw.quantize_int8(g.astype(jnp.float32), k)
        noise = np.asarray(jax.random.uniform(k, g.shape, jnp.float32) - 0.5)
        g_np = np.asarray(g, np.float32)
        assert g_np.shape == ((len(leaf),) + tuple(leaf[0].shape)
                              if isinstance(leaf, list)
                              else tuple(leaf.shape))
        q, s = quantize_int8(torch.from_numpy(g_np.copy()),
                             torch.from_numpy(noise.copy()))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        assert np.float32(s) == np.asarray(want_s), path


def test_int8_compression_keeps_one_scale_a_reference_leaf(smoke_grads):
    """The optimizer's int8 path on the port's per-layer gradients: a
    stacked leaf's layers share one scale, max |g| over all of them /
    127, and every value is a multiple of it within one step of g."""
    grads, model, cfg = smoke_grads
    leaves = reference_leaves(model, cfg)
    tree = jax.tree.map(np.asarray, grads)
    port = {}
    for path, leaf in leaves.items():
        a = tree
        for k in path:
            a = a[k]
        port[path] = [torch.from_numpy(x.copy()) for x in a] \
            if isinstance(leaf, list) else torch.from_numpy(a.copy())
    out = _compress_int8(port, step=5)
    again = _compress_int8(port, step=5)
    for path, leaf in port.items():
        g = torch.stack(leaf) if isinstance(leaf, list) else leaf
        d = torch.stack(out[path]) if isinstance(leaf, list) else out[path]
        s = g.abs().max() / 127.0 + 1e-30
        q = d / s
        assert torch.allclose(q, q.round(), atol=1e-3), path
        assert float((d - g).abs().max()) <= float(s) * 1.0001, path
        assert float(q.abs().max()) <= 127.0 + 1e-3
        # the noise is a function of (step, leaf index): repeatable
        e = torch.stack(again[path]) if isinstance(leaf, list) \
            else again[path]
        assert torch.equal(d, e)


# --------------------------------------------------------------------------
# checkpoints and the CLI
# --------------------------------------------------------------------------

CLI = ["--arch", "smollm-135m", "--smoke", "--steps", "4", "--ckpt-every",
       "2", "--log-every", "1", "--batch", "4", "--seq", "32"]


def _keep_step_2(path) -> None:
    for f in os.listdir(path):
        if f != "step_000000002.npz":
            os.remove(os.path.join(path, f))


def test_reference_checkpoint_resumes_in_port(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    want = ref_train.main(CLI + ["--ckpt-dir", ck])
    _keep_step_2(ck)
    got = train.main(CLI + ["--ckpt-dir", ck, "--device", "cpu"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(got) == 2
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)


def test_port_checkpoint_resumes_in_reference(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    want = train.main(CLI + ["--ckpt-dir", ck, "--device", "cpu"])
    assert np.all(np.isfinite(want)) and len(want) == 4
    _keep_step_2(ck)
    got = ref_train.main(CLI + ["--ckpt-dir", ck])
    assert "resumed from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)


def test_checkpoint_holds_the_reference_layout(tmp_path):
    """The port's step-2 file has the leaves, shapes and dtypes of the
    reference's."""
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    train.main(CLI[:3] + ["--steps", "2", "--ckpt-dir", ours, "--device",
                          "cpu", "--batch", "2", "--seq", "16"])
    ref_train.main(CLI[:3] + ["--steps", "2", "--ckpt-dir", theirs,
                              "--batch", "2", "--seq", "16"])
    with np.load(os.path.join(ours, "step_000000002.npz")) as a, \
            np.load(os.path.join(theirs, "step_000000002.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].shape == b[f].shape and a[f].dtype == b[f].dtype, f


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_to_reference_round_trips(arch):
    """params_to_reference(params_from_reference(tree)) is the
    reference's own param tree, bitwise, leaf for leaf (stacked layers,
    MoE experts (L, E, ...), the hybrid's superblocks and unstacked
    tail)."""
    cfg = get_config(arch, smoke=True)
    _, want = _reference_params(ref_config(arch, smoke=True))
    got = params_to_reference(params_from_reference(want, cfg, "cpu"), cfg)
    got, want = _flatten(got), _flatten(want)
    assert list(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w)


def test_train_main_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device"):
        train.main(CLI[:3])
