"""The benchmark's harness on the CPU: cells, traffic and metrics found
by name, the generators deterministic from the seed, the work counts
against hand-counted shapes, no fallback to the CPU, and no JAX."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from portbench import check, data, harness, keys, work
from portbench.run import load_cell, main, metrics_of, read_metric

harness.port_path()
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_found_by_name(workload):
    bench, w, cfg, traffic, limits = load_cell(workload)
    assert cfg["name"] == w["config"]
    runner = importlib.import_module(
        f"portbench.runners.{traffic['kind']}")
    assert callable(runner.run)
    assert limits and all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in metrics_of(bench, workload, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert metrics_of(bench, workload, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    # a reader of a record with nothing in it reports nothing
    assert read_metric(metric, {"trace": None, "iters": 1}) is None


def test_dotted_metric_reads_as_its_quantity():
    facts = dict(iters=4, window_s=2.0, trace=dict(
        kernel_s={"gibbs_flip_kernel(float const*)": 0.02}, busy_s=0.5,
        window_s=2.0, syncs=8),
        launches=work.uncollapsed_launches(1024, 64, 36))
    for base in ("sweep_ms", "sync_ms", "host_syncs", "device_idle",
                 "iter_mfu", "gibbs_flip_roofline"):
        want = read_metric(base, facts)
        assert want is not None and read_metric(f"{base}.step", facts) == want
    assert read_metric("sweep_ms.step", facts) == pytest.approx(5.0)


@pytest.mark.parametrize("kind", sorted(
    f[:-3] for f in os.listdir(os.path.join(harness.HERE, "datakinds"))
    if f.endswith(".py") and not f.startswith("_")))
def test_data_kind_found_by_name(kind):
    cfgs = [harness.load_json(harness.ROOT, c["file"])
            for c in BENCH["configs"]]
    cfg = next(c for c in cfgs if c["data"]["kind"] == kind)
    A = data.features(cfg, 2**31 + 3, "cpu")
    assert A.dtype == torch.float32 and A.shape[1] == cfg["D"]


def test_the_stage_hooks_are_the_programs():
    # the hybrid runner watches the iteration's stages through these
    from repro_torch.core.ibp import collapsed, hybrid, sweeps
    assert hybrid.uncollapsed_sweep is sweeps.uncollapsed_sweep
    assert hybrid.collapsed_row_scan is collapsed.collapsed_row_scan


def test_benchmark_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in ends
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends and set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            harness.HERE, "traffic", f"{w['traffic']}.json"))


def test_data_deterministic_from_seed():
    cfg = harness.load_json(harness.HERE, "configs", "cambridge-d36.json")
    a = data.rows(cfg, 2**31 + 5, 64, "cpu")
    assert torch.equal(a, data.rows(cfg, 2**31 + 5, 64, "cpu"))
    assert not torch.equal(a, data.rows(cfg, 2**31 + 6, 64, "cpu"))
    assert a.shape == (64, 36)


def test_keys_follow_the_programs():
    from repro_torch import prng
    k = prng.key(2**33 + 9)
    assert keys.word(k) == keys.key(2**33 + 9)
    assert keys.word(prng.fold_in(k, 101)) == keys.fold_in(keys.word(k), 101)
    assert [keys.word(s) for s in prng.split(k, 3)] == \
        keys.split(keys.word(k), 3)
    g1, g2 = prng.generator(k, "cpu"), keys.generator(keys.word(k), "cpu")
    assert torch.equal(torch.rand(5, generator=g1),
                       torch.rand(5, generator=g2))


def test_work_counts_by_hand():
    # N=4 rows, K=2 columns, D=3, one live column
    w = work.gibbs_flip(4, 2, 3, 1)
    assert w == dict(tensor_flops=2 * 4 * 3 * 1, fp32_flops=6 * 4 * 1,
                     nbytes=4 * (4 * 3 + 3 * 4 * 2 + 2 * 3))
    assert work.feature_stats(4, 2, 3, 2) == dict(
        tensor_flops=2 * 4 * 2 * (2 + 3), fp32_flops=4 * 2,
        nbytes=4 * (12 + 8 + 4 + 6 + 2))
    assert work.gaussian_sse(4, 2, 3, 2)["nbytes"] == 4 * (12 + 8 + 6 + 2)
    s = work.collapsed_scan(10, 2, 3, 1)
    assert s["fp32_flops"] == 10 * (13 * 2 * 3 + 16 * 3 + 1 * (6 * 2 + 20))
    t, by = work.least(tensor_flops=495e12, fp32_flops=67e12 / 2,
                       nbytes=3.35e12 / 4)
    assert (t, by) == (1.0, "tensor")
    runs = work.hybrid_launches(N=64, K_max=8, K_tail=4, D=16, P=4, L=5,
                                k_live=3, tail_live=0, N_eval=8,
                                eval_every=20)
    assert runs["gibbs_flip"][0][0] == 5 and runs["collapsed_scan"][0] == (
        5, work.collapsed_scan(16, 4, 16, 0))
    assert runs["gibbs_flip"][1][0] == pytest.approx(3 / 20)


def test_roofline_reader_reports_nothing_without_the_kernel():
    facts = dict(iters=2, window_s=1.0, trace=dict(
        kernel_s={"gibbs_flip_kernel(float const*)": 0.01}, busy_s=0.5,
        window_s=1.0, syncs=4),
        launches=work.uncollapsed_launches(1024, 64, 36))
    assert read_metric("collapsed_scan_roofline", facts) is None
    g = read_metric("gibbs_flip_roofline", facts)
    assert 0 < g <= 100
    assert read_metric("device_idle.sample", facts) == pytest.approx(50.0)
    assert read_metric("host_syncs.sample", facts) == 2


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_held_fails_closed():
    ok, rows = check.held({"a": 1.0, "b": float("nan")}, {"a": 2.0, "b": 1})
    assert not ok and rows == [["a", 1.0, 2.0], ["b", rows[1][1], 1]]
    assert not check.held({"c": 0.0}, {})[0]


def test_forbidden_modules_by_whole_top_level_name():
    assert harness.forbidden_modules(
        ["repro_torch.core", "jaxlib.xla", "reprox", "repro.core"]) == \
        ["jaxlib", "repro"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import portbench.reference, portbench.check, portbench.keys, "
            "portbench.work, portbench.data; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().replace("'", '"')) == []
