"""The port's serving loop (``repro_torch.launch.serve_ibp``) on the CPU.

* The row-bucket helpers equal the reference's.
* ``serve`` answers one response per request, with each request's rows,
  for every op, including a zero-row request and one larger than the
  batch; the per-request answers are those of the op on the request's
  rows alone where the op is deterministic given the bank (impute's
  observed entries).
* ``main(["--smoke", "--device", "cpu", ...])`` runs end to end on a
  bank harvested by the port's CLI, and the default device wants a GPU.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from _torch_cases import bank_samples

from repro.launch import serve_ibp as jserve
from repro_torch.core.ibp.predict import BankBuilder
from repro_torch.launch import mcmc, serve_ibp

torch.set_num_threads(1)


def _bank(K_max=16, lives=(5, 9, 7), D=12):
    bb = BankBuilder(K_max)
    for kw in bank_samples(K_max, lives, D, seed=3):
        bb.add(**kw)
    return bb.build("cpu")


@pytest.mark.parametrize("batch", [256, 64, 48, 8])
def test_row_buckets_and_padding_match_the_reference(batch):
    assert serve_ibp.row_buckets(batch) == jserve.row_buckets(batch)
    bs = serve_ibp.row_buckets(batch)
    for n in (1, 5, 8, min(batch, 16), batch):
        X = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1.0
        got, want = (serve_ibp.pad_to_bucket(X, bs),
                     jserve.pad_to_bucket(X, bs))
        np.testing.assert_array_equal(got, want)
        assert got.shape[0] in bs and not got[n:].any()


@pytest.mark.parametrize("op", serve_ibp.OPS)
def test_serve_answers_every_request_with_its_rows(op):
    bank = _bank()
    rng = np.random.default_rng(7)
    sizes = [3, 0, 40, 1, 12]  # a zero-row request, one beyond the batch
    reqs = []
    for n in sizes:
        rows = rng.standard_normal((n, bank.D)).astype(np.float32)
        mask = (rng.random((n, bank.D)) > 0.25).astype(np.float32)
        reqs.append((rows, mask))
    responses, stats = serve_ibp.serve(bank, reqs, op, batch=16, n_sweeps=2,
                                       seed=1)
    assert len(responses) == len(reqs)
    for (rows, mask), resp in zip(reqs, responses):
        n = rows.shape[0]
        want = {"encode": (bank.S, n, bank.K), "impute": (n, bank.D),
                "loglik": (n,), "anomaly": (n,)}[op]
        assert resp.shape == want and np.all(np.isfinite(resp))
        if op == "impute":  # observed entries pass through
            np.testing.assert_array_equal(resp[mask > 0.5], rows[mask > 0.5])
        if op == "anomaly" and n:
            assert np.all(resp > 0)  # − log-likelihood of continuous rows
    assert stats["rows"] == sum(sizes) and stats["requests"] == len(reqs)
    assert stats["device"] == "cpu"
    for k in ("op", "S", "K", "D", "batch", "n_sweeps", "rows_per_s",
              "latency_p50_us", "latency_p95_us", "warmup_s"):
        assert k in stats, k


def test_synth_requests_cycle_through_given_rows():
    X = np.arange(20, dtype=np.float32).reshape(10, 2)
    reqs = serve_ibp.synth_requests(6, 4, 2, seed=0, missing=0.5, X=X)
    rows = np.concatenate([r for r, _ in reqs])
    np.testing.assert_array_equal(rows, X[np.arange(len(rows)) % 10])
    assert all(m.sum(1).min() >= 1 for _, m in reqs)
    with pytest.raises(ValueError, match="D=2"):
        serve_ibp.synth_requests(2, 4, 3, seed=0, missing=0.0, X=X)


def test_merge_bench_json_appends_serving_sections(tmp_path):
    path = str(tmp_path / "bench.json")
    serve_ibp.merge_bench_json({"op": "loglik"}, path)
    serve_ibp.merge_bench_json({"op": "encode"}, path)
    with open(path) as fh:
        got = json.load(fh)
    assert [s["op"] for s in got["serving_loop"]] == ["loglik", "encode"]


@pytest.mark.parametrize("op", serve_ibp.OPS)
def test_main_smoke_serves_a_bank_harvested_by_the_cli(tmp_path, capsys, op):
    bank_path = str(tmp_path / "bank.npz")
    drv = mcmc.main(["--device", "cpu", "--N", "60", "--P", "2", "--iters",
                     "6", "--eval-every", "3", "--K-max", "8", "--K-tail",
                     "2", "--L", "2", "--harvest-every", "2",
                     "--harvest-burn", "0.4", "--bank-path", bank_path,
                     "--ckpt-dir", str(tmp_path / "ck"),
                     "--out", str(tmp_path / "h.json")])
    assert len(drv.bank_builder) == 2  # iterations 4 and 6 (burn 2)
    assert f"sample bank (2 samples) -> {bank_path}" in capsys.readouterr().out
    responses, stats = serve_ibp.main(["--smoke", "--device", "cpu",
                                       "--bank", bank_path, "--op", op])
    out = capsys.readouterr().out
    assert "smoke OK" in out and "bank: S=2 samples" in out
    assert stats["S"] == 2 and len(responses) == stats["requests"] == 8
    assert not list(tmp_path.glob("BENCH_*.json"))


def test_main_needs_a_gpu_unless_told_cpu(monkeypatch, tmp_path):
    path = _bank().save(str(tmp_path / "bank.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_ibp.main(["--smoke", "--bank", path])
