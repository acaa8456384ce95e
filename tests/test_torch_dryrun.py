"""The dry run on meshes of H100s (``repro_torch.launch.specs`` and
``launch.dryrun``) against the reference's specs and against real runs,
on the CPU (fake tensors on ``cpu``: a CPU-only torch makes fake CUDA
tensors but cannot fill them).

* ``input_specs``, ``abstract_model`` (grouped by
  ``interop.reference_leaves``, serve and train) with ``param_bytes``,
  and ``abstract_caches``: the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s, all ten configs at full width.
* The production meshes; importing the dry run starts no group and
  touches no device.
* A dry run's collectives (by kind, count, bytes and group) equal those
  of real gloo ranks running the same step (``_torch_dryrun_ranks``): a
  dense config's train, prefill and decode steps on a (2, 2) mesh and
  its train step on a (1, 2, 2) ("pod", "data", "model") mesh, whose
  batch splits over the run of axes ("pod", "data"), and the MoE's a2a
  train step on (2, 2); the IBP cell's collectives (3 all-reduces an
  iteration staged, 1 fused) at P=256 equal a real run's at P=4. The
  real ranks also gather slices split over runs of axes back whole.
* Rank 0's FLOPs on a (4, 1) mesh, times 4, equal ``FlopCounterMode``
  of the unsharded step on real tensors, exactly; the memory tracker's
  peak on fake tensors equals its peak over the same step on real
  tensors; the depth probes' extrapolation equals the full cell's FLOPs.
* ``run_cell`` writes its record, skips ``long_500k`` of a full-attention
  config with the reference's reason, records a failing cell as an
  error, and ``main`` returns 1 for it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import _torch_dryrun_ranks as ranks
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ALL_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import shape_applicable as ref_applicable
from repro.launch import specs as ref_specs
from repro_torch import parallel
from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, LONG_500K,
                                 ShapeConfig, get_config)
from repro_torch.interop import reference_leaves
from repro_torch.launch import dryrun, specs
from repro_torch.models import init_model, make_train_step, transformer
from repro_torch.optim import AdamW
from repro_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
LIMIT_S = 240.0
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _dtype(x) -> str:
    """A jax or torch dtype's name (``bfloat16``, ``int32``, ...)."""
    return str(x.dtype).replace("torch.", "")


def _ref_flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _smoke(arch: str, **kw):
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


# --------------------------------------------------------------------------
# (a)-(c) the specs against the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape, rshape in zip(ALL_SHAPES, REF_SHAPES):
        assert shape.name == rshape.name
        got = specs.input_specs(cfg, shape)
        want = ref_specs.input_specs(rcfg, rshape)
        assert sorted(got) == sorted(want), shape.name
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype(t)) == (
                tuple(want[k].shape), _dtype(want[k])), (shape.name, k)


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_model_matches_reference(arch, serve):
    cfg = get_config(arch)
    model, pspecs = specs.abstract_model(cfg, serve=serve)
    rstruct, _ = ref_specs.abstract_model(ref_config(arch), serve=serve)
    want = _ref_flat(rstruct)
    leaves = reference_leaves(model, cfg)
    assert sorted(leaves) == sorted(want)
    for path, leaf in leaves.items():
        parts = leaf if isinstance(leaf, list) else [leaf]
        shape = ((len(parts), *parts[0].shape) if isinstance(leaf, list)
                 else tuple(leaf.shape))
        assert {_dtype(p) for p in parts} == {_dtype(want[path])}, path
        assert shape == tuple(want[path].shape), path
    assert all(p.device.type == "meta" for p in model.parameters())
    assert set(pspecs) == {n for n, _ in model.named_parameters()}
    # the reference's count in exact integers; its own function takes each
    # leaf's size as an int32 jnp.prod, which wraps past 2^31 elements
    # (six of the ten configs), and agrees wherever no leaf is that large
    exact = sum(math.prod(x.shape) for x in want.values())
    wraps = max(math.prod(x.shape) for x in want.values()) >= 2**31
    for nbytes in (2, 4):
        assert specs.param_bytes(model, nbytes) == nbytes * exact
        assert (specs.param_bytes(model, nbytes) != ref_specs.param_bytes(
            rstruct, nbytes)) == wraps
    assert specs.param_bytes(dict(model.named_parameters())) == 2 * exact


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_caches_match_reference(arch):
    cfg, B, S = get_config(arch), 2, 64
    got = specs.abstract_caches(cfg, B, S)
    want = ref_specs.abstract_caches(ref_config(arch), B, S)
    if cfg.family == "hybrid":   # (superblocks by pattern position, tail)
        pat, n_super, _ = transformer._hybrid_layout(cfg)
        per = [(want[0][j % len(pat)], True)
               for j in range(n_super * len(pat))]
        per += [(w, False) for w in want[1]]
    else:
        per = [(want, True)] * cfg.n_layers
    assert len(got) == len(per)
    for g, (w, stacked) in zip(got, per):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape[1:] if stacked
                                           else b.shape)
            assert _dtype(a) == _dtype(b)


def test_production_meshes_are_h100_clusters():
    pod1 = pmesh.make_production_mesh()
    pod2 = pmesh.make_production_mesh(multi_pod=True)
    assert (pod1.axis_names, tuple(pod1.shape.values())) == (AXES, (32, 8))
    assert (pod2.axis_names, tuple(pod2.shape.values())) == (
        POD_AXES, (2, 32, 8))
    assert pmesh.mesh_axes(pod2)["dp_size"] == 64
    # a (2, 32, 8) world makes one group a line of every axis and a block
    # of every run of two axes: 256 + 16 + 64 + 8 + 2
    with parallel.fake_world(0, 512, "cpu"):
        made = []
        real = parallel.group.dist.new_group
        parallel.group.dist.new_group = lambda r: made.append(r) or real(r)
        try:
            mesh = parallel.make_mesh((2, 32, 8), POD_AXES)
        finally:
            parallel.group.dist.new_group = real
        assert len(made) == 346
        span = parallel.axes_group(mesh, ("pod", "data"))
        assert span.name == "pod+data" and span.ranks == tuple(
            range(0, 512, 8))
        assert parallel.axes_group(mesh, POD_AXES) is None
    assert parallel.world() is None


def test_dryrun_imports_start_no_group_and_touch_no_device():
    code = ("import sys, torch, torch.distributed as dist, "
            "repro_torch.launch.dryrun; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules); "
            "assert not dist.is_initialized(); "
            "assert not torch.cuda.is_initialized()")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# --------------------------------------------------------------------------
# (d), (i) the dry run's collectives against real gloo ranks
# --------------------------------------------------------------------------


DENSE = _smoke("smollm-135m")
MOE = _smoke("phi3.5-moe-42b-a6.6b", capacity_factor=2.0)
LM_CASES = [
    (DENSE, dict(name="t", seq_len=32, global_batch=4, mode="train"),
     (2, 2), AXES),
    (DENSE, dict(name="p", seq_len=32, global_batch=4, mode="prefill"),
     (2, 2), AXES),
    (DENSE, dict(name="d", seq_len=32, global_batch=4, mode="decode"),
     (2, 2), AXES),
    (MOE, dict(name="t", seq_len=32, global_batch=4, mode="train"),
     (2, 2), AXES),
    (DENSE, dict(name="t", seq_len=32, global_batch=4, mode="train"),
     (1, 2, 2), POD_AXES),
]
IBP = dict(K_max=16, K_tail=4, L=2)
SYNCS = ("staged", "fused")


@pytest.fixture(scope="module")
def real_cells():
    return parallel.spawn(ranks.cells, 4, LM_CASES, 1024, IBP, SYNCS,
                          device="cpu", timeout_s=LIMIT_S)


@pytest.mark.parametrize("case", range(len(LM_CASES)),
                         ids=["dense-train", "dense-prefill", "dense-decode",
                              "moe-a2a-train", "dense-train-pod"])
def test_dryrun_collectives_equal_real_ranks(case, real_cells):
    cfg, kw, sizes, names = LM_CASES[case]
    rec = dryrun.trace_step(cfg, ShapeConfig(**kw),
                            pmesh.mesh_shape(sizes, names), device="cpu")
    got = (rec["collectives"], rec["collectives_by_group"])
    assert got[0]["total"] > 0
    for rank, (lm_got, _, _) in enumerate(real_cells):
        coll, by_group = lm_got[case]
        assert got == (coll, by_group), rank
    if kw["mode"] == "train":
        assert got[0]["counts"]["reduce-scatter"] > 0
    if cfg is MOE:
        assert by_group["model"]["counts"]["all-to-all"] > 0
    if len(sizes) == 3:   # the batch and FSDP over ("pod", "data")
        assert by_group["pod+data"]["counts"]["all-gather"] > 0


def test_real_ranks_gather_slices_split_over_runs_of_axes(real_cells):
    for _, _, whole_ok in real_cells:
        assert whole_ok


@pytest.mark.parametrize("sync", SYNCS)
def test_ibp_cell_collectives_equal_real_ranks(sync, real_cells, tmp_path):
    rec = dryrun.run_ibp_cell("pod1", N=4096, sync=sync, device="cpu",
                              out_dir=str(tmp_path), **IBP)
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["P"], rec["rows_per_rank"]) == (256, 16)
    c = rec["collectives"]
    assert c["counts"] == {"all-reduce": 3 if sync == "staged" else 1,
                           "all-gather": 0, "reduce-scatter": 0,
                           "all-to-all": 0, "collective-permute": 0}
    K, Kt, D = IBP["K_max"], IBP["K_tail"], 36
    # the staged payloads (K_tail + 1, K^2 + K D + K, 1) and the fused one
    # carry the same floats
    assert c["total"] == 4 * (Kt + 1 + K * K + K * D + K + 1)
    want = real_cells[0][1][SYNCS.index(sync)]
    assert (c, rec["collectives_by_group"]) == want
    assert rec["flops_scope"] == "aten" and rec["flops"] > 0
    assert rec["memory"]["peak_source"] == "MemoryTracker"
    assert os.path.exists(tmp_path / (
        "ibp-hybrid__mcmc_1m" + ("" if sync == "staged" else "-fused")
        + "__pod1.json"))


# --------------------------------------------------------------------------
# (e)-(g) FLOPs and memory against real tensors, the depth probes
# --------------------------------------------------------------------------


def test_dryrun_flops_times_ranks_equal_unsharded_step():
    shape = ShapeConfig("t", 32, 8, "train")
    rec = dryrun.trace_step(DENSE, shape, pmesh.mesh_shape((4, 1), AXES),
                            device="cpu")
    model = init_model(0, DENSE, device="cpu")
    opt = AdamW(lr=1e-4)
    state = opt.init(reference_leaves(model, DENSE))
    batch = {k: torch.zeros(8, 32, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        make_train_step(DENSE, opt)(model, state, batch)
    assert rec["flops"] * 4 == fc.get_total_flops() > 0


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_memory_estimate_on_fake_tensors_equals_real_tensors(mode):
    shape = ShapeConfig("t", 32, 8, mode)
    rec = dryrun.trace_step(DENSE, shape, pmesh.mesh_shape((4, 1), AXES),
                            device="cpu")
    with parallel.fake_world(0, 4, "cpu"):
        mesh = parallel.make_mesh((4, 1), AXES)
        step, args = dryrun.build_step(DENSE, shape, mesh, device="cpu")
        _, _, mem, arg_bytes = dryrun.measure(step, args, "cpu")
    m = rec["memory"]
    assert m["argument_size_in_bytes"] == arg_bytes
    assert abs(m["peak_bytes"] - mem.peak) <= 0.01 * mem.peak
    assert m["peak_bytes"] == m["argument_size_in_bytes"] + \
        m["temp_size_in_bytes"]
    assert m["fits"]


def test_probe_extrapolation_equals_full_cell(monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: _smoke(arch, n_layers=4))
    shape = ShapeConfig("t", 16, 32, "train")
    probe = dryrun.run_probe("smollm-135m", shape, "pod1", device="cpu",
                             out_dir=str(tmp_path))
    full = dryrun.run_cell("smollm-135m", shape, "pod1", device="cpu",
                           out_dir=str(tmp_path))
    assert probe["status"] == full["status"] == "ok"
    L1, L2 = probe["L1"], probe["L2"]
    f1, f2 = (probe["probes"][str(L)]["flops"] for L in (L1, L2))
    assert f1 + (4 - L1) / (L2 - L1) * (f2 - f1) == full["flops"]


# --------------------------------------------------------------------------
# (h) records, skips, errors
# --------------------------------------------------------------------------


def test_run_cell_records_skips_and_errors(monkeypatch, tmp_path):
    out = str(tmp_path)
    rec = dryrun.run_cell("granite-3-8b", LONG_500K, "pod2", device="cpu",
                          out_dir=out)
    rshape = [s for s in REF_SHAPES if s.name == "long_500k"][0]
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_applicable(ref_config("granite-3-8b"),
                                           rshape)[1]
    with open(tmp_path / "granite-3-8b__long_500k__pod2.json") as fh:
        assert json.load(fh) == rec

    monkeypatch.setattr(dryrun, "get_config", _smoke)
    shape = ShapeConfig("train_4k", 32, 64, "train")
    rec = dryrun.run_cell("smollm-135m", shape, "pod2", device="cpu",
                          out_dir=out)
    assert rec["status"] == "ok"
    for k in ("arch", "shape", "mesh", "mode", "seq_len", "global_batch",
              "trace_s", "flops", "bytes_accessed", "collectives",
              "collectives_by_group", "memory"):
        assert k in rec, k
    assert set(rec["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "workspace_bytes", "peak_bytes", "fits"}
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVE_OPS) | {
        "counts", "total"}
    assert set(rec["collectives_by_group"]) <= {
        "pod", "data", "model", "pod+data", "data+model", "world"}
    # a record written is kept unless forced
    assert dryrun.run_cell("smollm-135m", shape, "pod2", device="cpu",
                           out_dir=out) == rec

    def broken(*a, **k):
        raise RuntimeError("a forced failure")

    monkeypatch.setattr(dryrun, "build_step", broken)
    rec = dryrun.run_cell("smollm-135m", shape, "pod2", force=True,
                          device="cpu", out_dir=out)
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: a forced failure"
    assert "a forced failure" in rec["traceback"]
    assert parallel.world() is None    # the fake world was left
    monkeypatch.setattr(dryrun, "ARTIFACTS", str(tmp_path / "main"))
    monkeypatch.setattr(dryrun, "ALL_SHAPES", (shape,))
    argv = ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
            "pod1", "--device", "cpu"]
    assert dryrun.main(argv) == 1
    monkeypatch.undo()
    monkeypatch.setattr(dryrun, "get_config", _smoke)
    monkeypatch.setattr(dryrun, "ARTIFACTS", str(tmp_path / "main"))
    monkeypatch.setattr(dryrun, "ALL_SHAPES", (shape,))
    assert dryrun.main(argv + ["--force"]) == 0
