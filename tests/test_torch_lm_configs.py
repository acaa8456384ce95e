"""The port's LM configs, parameter shapes, initialisation, refusals,
synthetic data, weight carrying and serving CLI, against the reference
on the CPU.

* Every config of the ten architectures, full and smoke, equals the
  reference's field by field, with the same parameter counts.
* At full width, the port's parameters (built on the meta device, nothing
  allocated) have the shapes of the reference's ``init_model`` under
  ``jax.eval_shape``, layer by layer (superblock by superblock for the
  hybrid), for all ten architectures.
* ``init_model`` draws each tensor from a ``torch.Generator`` with the
  reference's spread, deterministically; ``make_train_step`` no longer
  refuses (ROADMAP item 11b is done): it takes a step, and its optimizer
  refuses an unknown gradient compression.
* ``SyntheticLM`` gives the reference's batches bitwise.
* ``params_from_reference`` raises on a missing and on a spare leaf, and
  maps the hybrid's stacked superblocks and its tail.
* ``serve.main`` runs on the CPU for the ten architectures and wants a
  GPU by default.
"""
from __future__ import annotations

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.synthetic_lm import SyntheticLM as RefSyntheticLM
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.data.synthetic_lm import SyntheticLM
from repro_torch.interop import params_from_reference, reference_leaves
from repro_torch.launch import serve
from repro_torch.models import init_caches, init_model, make_train_step
from repro_torch.optim import AdamW

torch.set_num_threads(1)

PORTED = ("smollm-135m", "granite-3-8b", "codeqwen1.5-7b", "minicpm3-4b",
          "whisper-large-v3", "internvl2-76b", "falcon-mamba-7b",
          "recurrentgemma-2b", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b")
# the std of a standard normal truncated to ±2
TRUNC_STD = 0.8796256610342398


def _unstacked_shapes(tree, prefix=()) -> dict[str, tuple]:
    """The reference's param tree as port parameter names -> shapes."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(_unstacked_shapes(v, path))
        elif path[0] in ("layers", "enc_layers", "superblocks"):
            for i in range(v.shape[0]):
                out[".".join((path[0], str(i)) + path[1:])] = tuple(
                    v.shape[1:])
        else:
            out[".".join(path)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_reference(arch, smoke):
    got, want = (configs.get_config(arch, smoke),
                 ref_configs.get_config(arch, smoke))
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.param_count_active() == want.param_count_active()
    assert (got.hd, got.dt_rank, got.d_inner) == \
        (want.hd, want.dt_rank, want.d_inner)
    for shape, rshape in zip(configs.ALL_SHAPES, ref_configs.ALL_SHAPES):
        assert dataclasses.asdict(shape) == dataclasses.asdict(rshape)
        assert configs.shape_applicable(got, shape) == \
            ref_configs.shape_applicable(want, rshape)


def test_config_registry_equals_reference():
    from repro.configs import base as ref_base
    from repro_torch.configs import base

    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert base.SUBQUADRATIC == ref_base.SUBQUADRATIC
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", PORTED)
def test_full_width_param_shapes_match_reference(arch):
    cfg = configs.get_config(arch)
    model = init_model(0, cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert all(p.device.type == "meta" for p in model.parameters())
    abstract = jax.eval_shape(
        lambda k: ref_tf.init_model(k, ref_configs.get_config(arch))[0],
        jax.random.key(0))
    want = _unstacked_shapes(abstract)
    assert got == want
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm3-4b",
                                  "whisper-large-v3", "falcon-mamba-7b",
                                  "recurrentgemma-2b", "deepseek-v2-236b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_init_model_spread_matches_reference_formula(arch):
    """Each matrix: mean ~0 and std = TRUNC_STD / sqrt(shape[-2]) within
    6 standard errors, all within ±2 of its scale; enc_embed and the
    experts' wi and wo 0.02 N(0, 1), conv_w 0.1 N(0, 1); A_log
    log(1 + arange(n)) on every row; lam 0.65; norm scales and D ones."""
    cfg = configs.get_config(arch, smoke=True)
    model = init_model(torch.Generator().manual_seed(3), cfg, device="cpu")
    for name, p in model.named_parameters():
        w = p.detach().double()
        leaf = name.split(".")[-1]
        if leaf == "A_log":
            want = torch.log1p(torch.arange(p.shape[-1], dtype=torch.float64))
            assert torch.equal(p, want.float().expand_as(p)), name
            continue
        if leaf == "lam":
            assert torch.equal(p, torch.full_like(p, 0.65)), name
            continue
        if p.dim() == 1:
            assert torch.equal(p, torch.ones_like(p)), name
            continue
        n = w.numel()
        if name == "enc_embed" or name.endswith(("moe.wi", "moe.wo")):
            sd = 0.02
        elif leaf == "conv_w":
            sd = 0.1
        else:
            scale = 1.0 / max(1.0, p.shape[-2]) ** 0.5
            sd = TRUNC_STD * scale
            assert float(w.abs().max()) <= 2.0 * scale * (1 + 1e-6), name
        assert abs(float(w.mean())) < 6 * sd / n ** 0.5, name
        assert abs(float(w.std()) / sd - 1) < 6 / (2 * n) ** 0.5, name


def test_init_model_is_deterministic_in_its_seed():
    cfg = configs.get_config("smollm-135m", smoke=True)
    a = init_model(0, cfg, device="cpu")
    b = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    c = init_model(1, cfg, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if pa.dim() > 1:
            assert not torch.equal(pa, pc), name


def test_make_train_step_is_refused_by_item():
    """Item 11b is ported: the step runs (a finite loss) where it raised
    NotImplementedError; what is refused now is an unknown option."""
    cfg = configs.get_config("smollm-135m", smoke=True)
    model = init_model(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=gen)}
    opt = AdamW(lr=1e-3)
    _, state, metrics = make_train_step(cfg, opt)(model, opt.init(
        reference_leaves(model, cfg)), batch)
    assert np.isfinite(float(metrics["loss"])) and int(state["step"]) == 1
    bad = AdamW(grad_compress="fp8")
    with pytest.raises(ValueError, match="grad_compress"):
        make_train_step(cfg, bad)(model, bad.init(
            reference_leaves(model, cfg)), batch)


@pytest.mark.parametrize("seed,step,n_shards", [(0, 0, 1), (3, 1, 1),
                                                (7, 12, 4)])
def test_synthetic_lm_batches_equal_reference(seed, step, n_shards):
    kw = dict(vocab=512, seq_len=32, global_batch=8, seed=seed,
              n_shards=n_shards)
    got, want = SyntheticLM(**kw), RefSyntheticLM(**kw)
    for shard in range(n_shards):
        a, b = got.batch(step, shard)["tokens"], want.batch(step, shard)[
            "tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def _ref_params_np(arch):
    cfg = ref_configs.get_config(arch, smoke=True)
    params, _ = ref_tf.init_model(jax.random.key(0), cfg)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-large-v3"])
def test_params_from_reference_raises_on_missing_and_spare_leaves(arch):
    cfg = configs.get_config(arch, smoke=True)
    params = _ref_params_np(arch)
    model = params_from_reference(params, cfg, "cpu")
    np.testing.assert_array_equal(model.layers[1].attn.wq.numpy(),
                                  params["layers"]["attn"]["wq"][1])
    missing = {**params, "layers": {k: v for k, v in params["layers"].items()
                                    if k != "ln2"}}
    with pytest.raises(ValueError, match="no reference leaf sets"):
        params_from_reference(missing, cfg, "cpu")
    spare = {**params, "layers": {**params["layers"],
                                  "extra": np.zeros((cfg.n_layers, 3))}}
    with pytest.raises(ValueError, match="has no parameter"):
        params_from_reference(spare, cfg, "cpu")
    bad = {**params, "final_ln": np.ones(cfg.d_model + 1, np.float32)}
    with pytest.raises(ValueError, match="final_ln"):
        params_from_reference(bad, cfg, "cpu")


def test_params_from_reference_maps_superblocks_and_tail():
    """The hybrid: superblocks/b{i}/... stacked over the superblocks goes
    to superblocks.{j}.b{i}...; tail/t{i}/... is not stacked."""
    cfg = configs.get_config("recurrentgemma-2b", smoke=True)
    params = _ref_params_np("recurrentgemma-2b")
    model = params_from_reference(params, cfg, "cpu")
    sb = params["superblocks"]
    assert len(model.superblocks) == sb["b0"]["rec"]["w_a"].shape[0] == 1
    np.testing.assert_array_equal(model.superblocks[0]["b0"].rec.w_a.numpy(),
                                  sb["b0"]["rec"]["w_a"][0])
    np.testing.assert_array_equal(model.superblocks[0]["b2"].attn.wq.numpy(),
                                  sb["b2"]["attn"]["wq"][0])
    np.testing.assert_array_equal(model.tail["t1"].rec.lam.numpy(),
                                  params["tail"]["t1"]["rec"]["lam"])
    assert [b.kind for b in model.decoder_blocks()] == \
        ["rglru", "rglru", "attn", "rglru", "rglru"]
    assert [b.window for b in model.decoder_blocks()] == [0, 0, 8, 0, 0]
    spare = {**params, "tail": {**params["tail"],
                                "t2": params["tail"]["t1"]}}
    with pytest.raises(ValueError, match="has no parameter"):
        params_from_reference(spare, cfg, "cpu")


@pytest.mark.parametrize("arch", PORTED)
def test_init_caches_take_one_cache_a_layer(arch):
    """init_caches: one cache a decoder layer in execution order, each
    with a 0-d int32 length, of the reference's kinds and shapes."""
    cfg = configs.get_config(arch, smoke=True)
    caches = init_caches(cfg, 2, 16, "cpu")
    assert len(caches) == cfg.n_layers
    ref = ref_tf.init_caches(ref_configs.get_config(arch, smoke=True), 2, 16)
    if cfg.family == "hybrid":
        sup, tail = ref
        want = [jax.tree.map(lambda a: a[0], c) for c in sup] + list(tail)
    else:
        want = [jax.tree.map(lambda a: a[0], ref)] * cfg.n_layers
    for got, w in zip(caches, want):
        assert type(got).__name__ == type(w).__name__
        assert [tuple(t.shape) for t in got] == [tuple(a.shape) for a in w]
        assert got.length.dtype == torch.int32 and int(got.length) == 0


@pytest.mark.parametrize("arch", PORTED)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    seq = serve.main(["--device", "cpu", "--smoke", "--arch", arch,
                      "--batch", "2", "--prompt-len", "5", "--new", "4"])
    assert seq.shape == (2, 9) and seq.dtype == torch.int64
    cfg = configs.get_config(arch, smoke=True)
    assert int(seq.min()) >= 0 and int(seq.max()) < \
        -(-cfg.vocab // 256) * 256
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"generated 2x4 tokens in \d+\.\d\ds \(\d+\.\d "
                        r"tok/s inc\. prefill\)", lines[-2]), lines
    assert lines[-1] == f"sample: {seq[0, -4:].tolist()}"


def test_serve_main_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device"):
        serve.main(["--smoke", "--new", "1", "--prompt-len", "2"])
