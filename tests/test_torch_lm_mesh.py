"""The LM on a mesh: the port's sharding rules against the reference's,
and the sharded steps on gloo ranks of the CPU against the unsharded
port and the reference.

* ``repro_torch.parallel.mesh``: the resolved parameter specs (train, and
  serve at the port's 80 GB budget, the reference's budget set to the
  port's), the activation, batch and cache specs of all ten configs,
  leaf by leaf, on the reference's meshes (16, 16), (2, 16, 16) and on
  H100-shaped (1, 8), (4, 8); which configs turn to inference-FSDP.
* On a (2, 2) mesh of ``parallel.spawn`` ranks (counterpart of
  ``tests/test_distributed.py::test_moe_a2a_matches_gather_dispatch``):
  the a2a MoE against the gather dispatch where nothing drops (y and aux
  within 2e-5, the gradients summed over the ranks against the
  unsharded ones), against the reference's ``_moe_a2a`` on 4 forced host
  devices where tokens drop (per-device capacity); ``sp_out_proj``
  against the unsharded product.
* On a (4, 2) mesh (counterpart of ``::test_lm_train_step_shards_on_8_
  devices``): the sharded loss and gradients against the unsharded port
  (loss 1e-6 relative; each gradient within 1e-6 of its norm) and the
  reference's ``jax.grad`` (every train case); one train step under
  each compression: the update equal to the unsharded AdamW's on the
  same gradients (1e-6 relative), int8 q bitwise; every rank holding only its slice of each
  sharded leaf and of its moments, a TP-sharded ``wq`` spread over the
  ranks; prefill and the decode loop on sharded caches equal to the
  unsharded port's and to the reference's (its prefill step, and its
  decode step under ``greedy_generate``'s loop).
* int8 compression on a mesh refuses a noise draw past its limit.
* Counterparts of ``tests/test_substrates.py``'s driver crash/restart,
  checkpoint retention and train/eval split tests.

Every spawn has a time limit (``LIMIT_S``); a rank's failure fails the
test.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import _torch_lm_mesh_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm_common import TOL, _inputs, assert_grads_match, grad_tree
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.models import lm as ref_lm
from repro.models import transformer as ref_tf
from repro.parallel import mesh as ref_mesh
from repro_torch import parallel
from repro_torch.checkpoint import all_steps, latest_step, save_pytree
from repro_torch.configs import ALL_SHAPES, ARCH_IDS, get_config
from repro_torch.data import cambridge_data, train_eval_split
from repro_torch.interop import params_to_reference, reference_leaves
from repro_torch.models import greedy_generate, lm, transformer
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import NOISE_LIMIT_BYTES, _compress_int8
from repro_torch.parallel import mesh as pmesh
from repro_torch.runtime import DriverConfig, MCMCDriver

torch.set_num_threads(1)

LIMIT_S = 240.0
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ((16, 16), (2, 16, 16), (1, 8), (4, 8))


def _names(sizes):
    return ("pod", "data", "model") if len(sizes) == 3 else ("data", "model")


def _entries(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _ref_flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's spec tree and param shapes (abstract) of ``arch``."""
    cfg = ref_config(arch)
    holder = {}

    def build(key):
        p, s = ref_tf.init_model(key, cfg)
        holder["s"] = s
        return p

    shapes = jax.eval_shape(build, jax.random.key(0))
    return holder["s"], shapes


@functools.lru_cache(maxsize=None)
def _port(arch: str):
    cfg = get_config(arch)
    model = transformer.LM(cfg, torch.device("meta"))
    return cfg, model, transformer.param_specs(model)


def _param_bytes(arch: str) -> int:
    _, model, _ = _port(arch)
    return 2 * sum(p.numel() for p in model.parameters())


# --------------------------------------------------------------------------
# the sharding rules against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, sizes, mode, monkeypatch):
    monkeypatch.setattr(ref_mesh, "SERVE_WEIGHT_BUDGET",
                        pmesh.SERVE_WEIGHT_BUDGET)
    names = _names(sizes)
    spec_tree, shapes = _reference(arch)
    pbytes = _param_bytes(arch)
    want = _ref_flat(ref_mesh.resolve_param_specs(
        spec_tree, shapes, AbstractMesh(sizes, names), mode=mode,
        param_bytes=pbytes))
    cfg, model, specs = _port(arch)
    got = pmesh.resolve_param_specs(
        specs, dict(model.named_parameters()),
        pmesh.mesh_shape(sizes, names), mode=mode, param_bytes=pbytes)
    names_of = {id(p): n for n, p in model.named_parameters()}
    leaves = reference_leaves(model, cfg)
    assert sorted(leaves) == sorted(want)
    for path, leaf in leaves.items():
        w = _entries(want[path])
        if isinstance(leaf, list):  # stacked: the reference's stack axis
            assert w[0] is None, path
            w = w[1:]
        for p in (leaf if isinstance(leaf, list) else [leaf]):
            assert _entries(got[names_of[id(p)]]) == w, (path, got[
                names_of[id(p)]], w)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "recurrentgemma-2b"])
def test_resolve_pspec_maps_placeholders(arch):
    """``modules.resolve_pspec`` (placeholders to axes, no fitting)
    against the reference's on its spec tree."""
    from repro.models.modules import resolve_pspec as ref_resolve
    from repro_torch.models.modules import resolve_pspec

    spec_tree, _ = _reference(arch)
    want = _ref_flat(ref_resolve(spec_tree, fsdp_axes=("pod", "data"),
                                 tp_axis="model"))
    cfg, model, specs = _port(arch)
    got = resolve_pspec(specs, fsdp_axes=("pod", "data"), tp_axis="model")
    names_of = {id(p): n for n, p in model.named_parameters()}
    for path, leaf in reference_leaves(model, cfg).items():
        w = _entries(want[path])
        w = w[1:] if isinstance(leaf, list) else w
        for p in (leaf if isinstance(leaf, list) else [leaf]):
            assert _entries(got[names_of[id(p)]]) == w, path


def test_inference_fsdp_at_80gb():
    """Serve mode adds FSDP where the TP-sharded bf16 weights pass the
    budget (9/16 of 80 GB): at tp=8 only deepseek-v2-236b (59 GB a
    card); at tp=16 none (TPU v5e's 9 GiB: deepseek-v2 and internvl2)."""
    def fsdp_archs(sizes):
        mesh = pmesh.mesh_shape(sizes, _names(sizes))
        out = set()
        for arch in ARCH_IDS:
            _, model, specs = _port(arch)
            got = pmesh.resolve_param_specs(
                specs, dict(model.named_parameters()), mesh, mode="serve",
                param_bytes=_param_bytes(arch))
            if any("data" in str(s) for s in got.values()):
                out.add(arch)
        return out

    assert pmesh.SERVE_WEIGHT_BUDGET == 45 * 10**9
    assert fsdp_archs((1, 8)) == fsdp_archs((4, 8)) == {"deepseek-v2-236b"}
    assert fsdp_archs((16, 16)) == set()


@pytest.mark.parametrize("sizes", MESHES)
def test_act_and_batch_specs_match_reference(sizes):
    names = _names(sizes)
    amesh, mesh = AbstractMesh(sizes, names), pmesh.mesh_shape(sizes, names)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sc in ALL_SHAPES:
            want = ref_mesh.resolve_shardings(ref_config(arch), sc, amesh)
            got = pmesh.resolve_shardings(cfg, sc, mesh)
            assert got["axes"] == want["axes"]
            assert _entries(got["act"].hid) == _entries(want["act"].hid)
            for f in ("feat", "exp", "logits"):
                assert _entries(got["reference"][f]) == _entries(
                    getattr(want["act"], f)), (arch, sc, f)
            for f in ("dp", "tp"):
                assert getattr(got["act"], f) == getattr(want["act"], f)
            assert got["reference"]["mlp_dp"] == want["act"].mlp_dp
            x = {"tokens": jax.ShapeDtypeStruct(
                (sc.global_batch, sc.seq_len), jnp.int32),
                "frames": jax.ShapeDtypeStruct(
                    (sc.global_batch, 7, cfg.d_model), jnp.float32)}
            wb = ref_mesh.batch_specs(x, amesh)
            gb = pmesh.batch_specs(x, mesh)
            assert {k: _entries(v) for k, v in gb.items()} == \
                {k: _entries(v) for k, v in wb.items()}


@pytest.mark.parametrize("sizes", MESHES)
def test_cache_specs_match_reference(sizes):
    """Each layer's cache: the reference's stacked leaf's spec without
    its stack axis (``layer_cache_specs``), and ``cache_specs`` itself on
    the reference's stacked leaves."""
    names = _names(sizes)
    amesh, mesh = AbstractMesh(sizes, names), pmesh.mesh_shape(sizes, names)
    for arch in ARCH_IDS:
        rcfg, cfg = ref_config(arch), get_config(arch)
        for B, S in ((128, 1024), (1, 4096), (24, 333)):
            ref = jax.eval_shape(lambda: ref_tf.init_caches(rcfg, B, S))
            want = ref_mesh.cache_specs(ref, amesh)
            got_stacked = pmesh.cache_specs(ref, mesh)
            assert jax.tree.leaves(jax.tree.map(
                lambda a, b: _entries(a) == _entries(b), got_stacked, want,
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
            layers = pmesh.layer_cache_specs(
                cfg, transformer.init_caches(cfg, B, S, "meta"), mesh)
            if cfg.family == "hybrid":
                pat, n_super, rest = transformer._hybrid_layout(cfg)
                per = [want[0][j % len(pat)] for j in range(n_super * len(pat))]
                per = [(w, True) for w in per] + [(w, False)
                                                 for w in want[1]]
            else:
                per = [(want, True)] * cfg.n_layers
            assert len(layers) == len(per)
            for got_c, (want_c, stacked) in zip(layers, per):
                for g, w in zip(got_c, want_c):
                    w = _entries(w)
                    assert _entries(g) == (w[1:] if stacked else w), \
                        (arch, B, S, g, w)


# --------------------------------------------------------------------------
# (2, 2): the MoE dispatches, sp_out_proj
# --------------------------------------------------------------------------


MOE_KW = dict(n_experts=8, top_k=2, d_model=32, d_ff_expert=16,
              n_shared_experts=1)


def _reference_moe(tmp_path, p: dict, x: np.ndarray):
    """The reference on 4 forced host devices in a subprocess (started,
    not waited for: ``.wait()``, then the npz at ``.out``): the
    single-device gather dispatch at capacity 8 (nothing drops), and its
    a2a on a (2, 2) mesh at capacity 1 (tokens drop per device), on the
    weights ``p`` and input ``x``."""
    src, out = tmp_path / "moe_in.npz", tmp_path / "ref_moe.npz"
    np.savez(src, x=x, **{"p_" + k: v for k, v in p.items()})
    code = f"""
        import dataclasses, numpy as np, jax, jax.numpy as jnp
        from repro.compat import AxisType, make_mesh, set_mesh
        from repro.configs import get_config
        from repro.models.moe import moe_apply
        from repro.parallel.mesh import act_specs
        cfg = dataclasses.replace(get_config('phi3.5-moe-42b-a6.6b',
                                             smoke=True), **{MOE_KW!r})
        f = np.load({str(src)!r})
        x = jnp.asarray(f['x'])
        p = {{k[2:]: jnp.asarray(f[k]) for k in f.files if k != 'x'}}
        y_g, aux_g = moe_apply(p, x, dataclasses.replace(
            cfg, moe_impl='gather', capacity_factor=8.0))
        mesh = make_mesh((2, 2), ('data', 'model'),
                         axis_types=(AxisType.Auto,) * 2)
        cfg_d = dataclasses.replace(cfg, moe_impl='a2a', capacity_factor=1.0)
        with set_mesh(mesh):
            specs = act_specs(mesh, seq_len=8, batch=4, mode='train')
            y_d, aux_d = jax.jit(
                lambda p, x: moe_apply(p, x, cfg_d, specs=specs))(p, x)
        np.savez({str(out)!r}, y_g=np.asarray(y_g), aux_g=float(aux_g),
                 y_d=np.asarray(y_d), aux_d=float(aux_d))
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    proc.out = out
    return proc


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    """The reference's MoE results (a subprocess) and every rank's of one
    4-rank spawn, run side by side."""
    rng = np.random.default_rng(4)
    d, E, ff = MOE_KW["d_model"], MOE_KW["n_experts"], MOE_KW["d_ff_expert"]
    p = {"router": rng.standard_normal((d, E)) / d ** 0.5,
         "wi": 0.02 * rng.standard_normal((E, d, 2 * ff)),
         "wo": 0.02 * rng.standard_normal((E, ff, d)),
         "shared_wi": rng.standard_normal((d, 2 * ff)) / d ** 0.5,
         "shared_wo": rng.standard_normal((ff, d)) / ff ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((4, 8, d)).astype(np.float32)
    proc = _reference_moe(tmp_path_factory.mktemp("moe"), p, x)
    kw = dict(MOE_KW, moe_impl="a2a")
    h = rng.standard_normal((4, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    try:
        res = parallel.spawn(
            ranks.mesh22_cases, 4,
            [(p, x, dict(kw, capacity_factor=8.0)),
             (p, x, dict(kw, capacity_factor=1.0))],
            [(h, w), (h[:, :7], w)], device="cpu", timeout_s=LIMIT_S)
        _, err = proc.communicate(timeout=LIMIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    ref = dict(np.load(proc.out), x=x)
    return ref, p, kw, (h, w), res


def test_moe_a2a_matches_gather_dispatch(mesh22):
    ref, p, kw, _, res = mesh22
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b", smoke=True),
                              **dict(kw, capacity_factor=8.0,
                                     moe_impl="gather"))
    mod = transformer.moe_lib.MoE(cfg, "cpu")
    with torch.no_grad():
        for n, t in mod.named_parameters():
            t.copy_(torch.from_numpy(p[n]))
            t.requires_grad_(True)
    x = torch.from_numpy(ref["x"]).requires_grad_()
    y, aux = transformer.moe_lib.moe_apply(mod, x, cfg)
    np.testing.assert_allclose(y.detach().numpy(), ref["y_g"], rtol=2e-5,
                               atol=2e-5)
    loss = (y * y).sum() + 0.01 * aux
    want = dict(zip([n for n, _ in mod.named_parameters()] + ["x"],
                    torch.autograd.grad(loss, [*mod.parameters(), x])))
    for r in res:
        got = r["moe"][0]
        np.testing.assert_allclose(got["y"], ref["y_g"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["aux"], float(ref["aux_g"]),
                                   rtol=2e-5)
        for n, g in got["grads"].items():
            assert np.all(np.isfinite(g)) and np.abs(g).max() > 0, n
            w = want[n].numpy()
            assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), n
        # two all-to-alls forward, two back; one all-reduce of the stats
        # forward, one back, one of the gradients
        assert r["moe"][0]["counts"][None]["all_to_all"] == 4
        assert r["moe"][0]["counts"]["model"]["all_to_all"] == 4
        assert r["moe"][0]["counts"]["world"]["all_reduce_sum"] == 3


def test_moe_a2a_drops_as_the_reference_per_device(mesh22):
    ref, _, _, _, res = mesh22
    for r in res:
        got = r["moe"][1]
        # capacity 1 a device drops tokens: the gather's output differs
        assert np.abs(got["y"] - ref["y_g"]).max() > 1e-3
        np.testing.assert_allclose(got["y"], ref["y_d"], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got["aux"], float(ref["aux_d"]),
                                   rtol=2e-5)


def test_sp_out_proj_matches_the_unsharded_product(mesh22):
    *_, (h, w), res = mesh22
    for r in res:
        for (hh, ww), out in zip(((h, w), (h[:, :7], w)), r["sp"]):
            want = hh @ ww
            for form, (got, n_rs) in out.items():
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
                # one reduce-scatter over the sequence; S=7 falls back
                assert n_rs == (1 if hh.shape[1] == 8 else 0), form


# --------------------------------------------------------------------------
# (4, 2): the train step, prefill and decode
# --------------------------------------------------------------------------

TRAIN_ARCHS = ("granite-3-8b", "deepseek-v2-236b", "recurrentgemma-2b",
               "whisper-large-v3")
DECODE_ARCHS = ("granite-3-8b", "deepseek-v2-236b", "falcon-mamba-7b")


@pytest.fixture(scope="module")
def mesh42():
    """Every rank's results, and the unsharded port's inputs and models,
    of one 8-rank spawn: the train cases (B=8, S=17), then the decode
    cases (B=4, a 5-token prompt, 3 new)."""
    train, decode = [], []
    for arch in TRAIN_ARCHS:
        cfg = ranks.config(arch)
        model = transformer.init_model(1, cfg, device="cpu")
        x = _inputs(cfg, seed=6)
        rng = np.random.default_rng(7)
        batch = {"tokens": rng.integers(0, cfg.vocab, (8, 17))}
        for k in ("frames", "patches"):
            if k in x:
                batch[k] = np.concatenate([x[k]] * 4)
        train.append((arch, cfg, model, batch))
    for arch in DECODE_ARCHS:
        cfg = ranks.config(arch)
        model = transformer.init_model(2, cfg, device="cpu")
        prompt = np.random.default_rng(8).integers(0, cfg.vocab, (4, 5))
        decode.append((arch, cfg, model, prompt))
    t_in = [(a, 1, b, a == "granite-3-8b") for a, _, _, b in train]
    d_in = [(a, 2, pr, 3) for a, _, _, pr in decode]
    res = parallel.spawn(ranks.mesh42_cases, 8, t_in, d_in, device="cpu",
                         timeout_s=LIMIT_S)
    return train, decode, res


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("i", range(len(TRAIN_ARCHS)),
                         ids=list(TRAIN_ARCHS))
def test_sharded_loss_and_grads_match_unsharded(mesh42, i):
    train, _, res = mesh42
    arch, cfg, model, batch = train[i]
    loss, metrics, grads = lm.loss_and_grads(model, _tb(batch), cfg)
    for r in res:
        got = r[0][i]
        assert abs(got["loss"] - float(loss)) <= 1e-6 * abs(float(loss))
        assert got["metrics"]["tokens"] == float(metrics["tokens"])
        np.testing.assert_allclose(got["metrics"]["aux"],
                                   float(metrics["aux"]), rtol=1e-5,
                                   atol=1e-7)
        for n, g in grads.items():
            w = g.numpy()
            err = np.linalg.norm(got["grads"][n] - w)
            assert err <= 1e-6 * np.linalg.norm(w) + 1e-12, (n, err)
    # every rank's whole gradients are the same
    for r in res[1:]:
        for n in grads:
            np.testing.assert_array_equal(r[0][i]["grads"][n],
                                          res[0][0][i]["grads"][n])


def _ref_cfg(arch: str):
    """The reference's counterpart of ``ranks.config``."""
    cfg = ref_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


@pytest.mark.parametrize("i", range(len(TRAIN_ARCHS)),
                         ids=list(TRAIN_ARCHS))
def test_sharded_grads_match_reference_grad(mesh42, i):
    """The (4, 2) sharded gradient of each train case (the MLA
    out-projection under sequence parallelism and the MoE on a mesh,
    the hybrid's mixers, the encoder's stream) against the reference's
    unsharded ``jax.grad`` on the same weights and batch."""
    train, _, res = mesh42
    arch, cfg, model, batch = train[i]
    rcfg = _ref_cfg(arch)
    params = jax.tree.map(jnp.asarray, params_to_reference(model, cfg))
    grads = jax.jit(jax.grad(lambda p, b: ref_lm.lm_loss(
        p, b, rcfg, ref_tf.ActSpecs())[0]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {k: np.asarray(v) for k, v in _ref_flat(grads).items()}
    got = grad_tree(model, cfg, {n: torch.from_numpy(g) for n, g in
                                 res[0][0][i]["grads"].items()})
    assert_grads_match(got, want)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_sharded_train_step_update_matches_unsharded(mesh42, compress):
    """One make_train_step on the mesh: its loss is the unsharded loss,
    and its new weights and moments are the unsharded AdamW's update on
    the same (gathered) gradients; int8 q equals the unsharded q
    bitwise on the same gradient."""
    train, _, res = mesh42
    arch, cfg, model, batch = train[0]
    r0 = res[0][0][0]
    loss, _, _ = lm.loss_and_grads(model, _tb(batch), cfg)
    u = transformer.init_model(1, cfg, device="cpu")
    opt = AdamW(lr=1e-3, grad_compress=compress)
    leaves = reference_leaves(u, cfg)
    state = opt.init(leaves)
    names = {id(p): n for n, p in u.named_parameters()}
    g = {path: [torch.from_numpy(r0["grads"][names[id(p)]]) for p in leaf]
         if isinstance(leaf, list)
         else torch.from_numpy(r0["grads"][names[id(leaf)]])
         for path, leaf in leaves.items()}
    _, state = opt.update(leaves, g, state)
    want_m = ranks._leaf_local(u, cfg, state["m"])
    want_v = ranks._leaf_local(u, cfg, state["v"])
    for r in res:
        st = r[0][0]["steps"][compress]
        assert r[0][0]["int8_bitwise"]
        assert abs(st["loss"] - float(loss)) <= 1e-6 * abs(float(loss))
        for n, p in u.named_parameters():
            for got, want in ((st["params"][n], p.detach().numpy()),
                              (st["m"][n], want_m[n].numpy()),
                              (st["v"][n], want_v[n].numpy())):
                scale = max(np.abs(want).max(), 1e-30)
                assert np.abs(got - want).max() <= 1e-6 * scale, n


def test_each_rank_holds_only_its_slices(mesh42):
    """Every TP- or FSDP-sharded leaf and its moments are the rank's
    slice: the local shape is the full shape over its spec's axes; a
    TP-sharded wq is spread over the ranks, the two tp ranks of a data
    row holding different halves; ``unshard_model`` gives the whole
    weights back."""
    train, _, res = mesh42
    arch, cfg, model, _ = train[0]
    mesh = pmesh.mesh_shape((4, 2), ("data", "model"))
    pspecs = pmesh.resolve_param_specs(
        transformer.param_specs(cfg), dict(model.named_parameters()), mesh,
        mode="train")
    n_split = 0
    for r in res:
        got = r[0][0]
        assert got["unshard_equal"]  # unshard_model gathers them back
        for n, full in got["full"].items():
            want = tuple(
                d // (1 if e is None else mesh.axis_size(e))
                for d, e in zip(full, tuple(pspecs[n]) + (None,) * 3))
            assert got["local"][n] == want, n
            assert got["steps"]["int8"]["local_m"][n] == want, n
            n_split += want != tuple(full)
    assert n_split > 0
    wq = {r[0][0]["coords"]: r[0][0]["wq"] for r in res}
    assert pspecs["layers.0.attn.wq"] == ("data", "model")
    assert not np.array_equal(wq[(0, 0)], wq[(0, 1)])
    full = model.layers[0].attn.wq.detach().numpy()
    np.testing.assert_array_equal(
        np.block([[wq[(d, t)] for t in range(2)] for d in range(4)]), full)


def test_sharded_collectives_by_kind_and_group(mesh42):
    """A sharded train step's collectives by kind and group (granite-3-8b,
    2 layers, remat, sequence parallel): a unit's weights in one
    all-gather an axis a pass (data, then model; the out-projection's
    rows stay tp-local), the top-level weights in one an axis; over
    model also the attention input's sequence gather a pass and the
    backward of sp_out_proj's reduce-scatter; one all-reduce of the token
    counts and the nll, and of the replicated leaves' gradients over each
    set of replica axes (data; the world)."""
    train, _, res = mesh42
    L = train[0][1].n_layers
    c = res[0][0][0]["counts"]
    assert c["data"]["all_gather"] == 1 + 2 * L
    assert c["model"]["all_gather"] == 1 + 5 * L
    assert c[None]["all_gather"] == c["data"]["all_gather"] + \
        c["model"]["all_gather"]
    for g in ("data", "model"):
        assert c[g]["reduce_scatter"] > 0
    assert c["world"]["all_reduce_sum"] == 2
    assert c["data"]["all_reduce_sum"] == 1


@pytest.mark.parametrize("i", range(len(DECODE_ARCHS)),
                         ids=list(DECODE_ARCHS))
def test_sharded_decode_matches_unsharded(mesh42, i):
    """Prefill and the decode loop on the mesh against the unsharded
    port, and against the reference on the same weights and prompt: its
    prefill step, and its decode step under ``greedy_generate``'s loop
    (the reference's own ``greedy_generate`` raises: ROADMAP §3)."""
    _, decode, res = mesh42
    arch, cfg, model, prompt = decode[i]
    new = 3
    want = greedy_generate(model, cfg, torch.from_numpy(prompt), new).numpy()
    last = lm.make_prefill_step(cfg)(model, {
        "tokens": torch.from_numpy(prompt)}).numpy()
    rcfg = _ref_cfg(arch)
    params = jax.tree.map(jnp.asarray, params_to_reference(model, cfg))
    ref_last = np.asarray(jax.jit(ref_lm.make_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(prompt)}))
    step = jax.jit(ref_lm.make_decode_step(rcfg))
    caches = ref_tf.init_caches(rcfg, *prompt.shape[:1],
                                prompt.shape[1] + new)
    tok = jnp.asarray(prompt[:, :1])
    ref_toks = [tok]
    for j in range(prompt.shape[1] + new - 1):
        nxt, caches = step(params, {"tokens": tok}, caches)
        tok = jnp.asarray(prompt[:, j + 1:j + 2]) \
            if j + 1 < prompt.shape[1] else nxt[:, None]
        ref_toks.append(tok)
    ref_toks = np.asarray(jnp.concatenate(ref_toks, 1))
    for r in res:
        got = r[1][i]
        np.testing.assert_array_equal(got["tokens"], want)
        np.testing.assert_array_equal(got["tokens"], ref_toks)
        np.testing.assert_allclose(got["prefill"], last, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["prefill"], ref_last, **TOL)
        # the caches are stored sharded where their spec says
        assert any(any(e is not None for e in s)
                   for c in got["cache_specs"] for s in c)
        # prefill gathers the last position's logits only: (B / dp, Vp)
        assert got["prefill_gathered"] == \
            prompt.shape[0] // 4 * transformer.pad_vocab(cfg.vocab)


def test_int8_on_a_mesh_refuses_a_noise_draw_past_its_limit():
    """A leaf whose whole float32 noise passes ``NOISE_LIMIT_BYTES``
    raises before any collective (deepseek-v2-236b's stacked experts, a
    layer: 160 x 5120 x 3072 float32, 10 GB, fit under it)."""
    mesh = pmesh.mesh_shape((4, 2), ("data", "model"))
    whole = (4 * 160, 5120, 3072)
    assert 4 * np.prod(whole) > NOISE_LIMIT_BYTES \
        >= 4 * np.prod(whole) // 4
    g = {"w": torch.zeros(2, 2)}
    with pytest.raises(ValueError, match="NOISE_LIMIT_BYTES"):
        _compress_int8(g, 1, mesh, {"w": parallel.Sharding(
            ("model", "data"), whole)})


# --------------------------------------------------------------------------
# counterparts of tests/test_substrates.py
# --------------------------------------------------------------------------


def test_checkpoint_retention(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in range(1, 6):
        save_pytree(str(tmp_path), tree, s, keep=3)
    assert all_steps(str(tmp_path)) == [3, 4, 5]


def test_train_eval_split_disjoint():
    X, _, _ = cambridge_data(N=100, seed=0)
    tr, ev = train_eval_split(X, eval_frac=0.2, seed=0)
    assert tr.shape[0] == 80 and ev.shape[0] == 20
    rows = {r.tobytes() for r in tr}
    assert not rows & {r.tobytes() for r in ev}
    assert len(rows | {r.tobytes() for r in ev}) == 100


def test_driver_crash_restart_and_elastic(tmp_path):
    X, _, _ = cambridge_data(N=48, seed=2)
    cfg = DriverConfig(P=4, K_max=16, K_tail=6, n_iters=20, ckpt_every=5,
                       eval_every=10, ckpt_dir=str(tmp_path))
    drv = MCMCDriver(X, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="injected crash"):
        drv.run(crash_at=12)
    assert latest_step(str(tmp_path)) == 10
    gs, ss = MCMCDriver(X, cfg, device="cpu").run()
    assert int(gs.it) == 20
    cfg2 = dataclasses.replace(cfg, P=2, n_iters=25)
    gs3, ss3 = MCMCDriver(X, cfg2, device="cpu").run()
    assert tuple(ss3.Z.shape) == (2, 24, 16)
    assert int(gs3.it) == 25
