"""The port's driver, checkpoints, CLI, device rules and import rules.

* Resume: on the CPU, 6 iterations in one go equal 3 iterations plus a
  resume for 3, bitwise (the state carries its own key).
* Checkpoints keep the reference's npz layout: each package reads the
  other's, and a reference checkpoint resumes in the port.
* Overflow: a promoted feature dropped for lack of a K_max slot makes the
  driver checkpoint and raise.
* Device: without ``device="cpu"`` the entry points want a GPU and raise
  when there is none; they never carry on on the CPU.
* Layouts and knobs: ``chains="mesh"`` is refused with its ROADMAP item,
  ``data="shardmap"`` outside a group of P ranks with both numbers; the
  CLI runs ``--driver shardmap`` on 4 gloo ranks; ``backend`` takes the
  reference's values and refuses others with its message.
* Imports: ``src/repro_torch`` and ``chip_smoke.py`` import no JAX and
  nothing of the reference package.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import _torch_shardmap_ranks as shardmap_ranks
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.core.ibp import SamplerSpec as JSpec
from repro.data import cambridge_data
from repro.runtime import MCMCDriver as JDriver
from repro_torch import parallel
from repro_torch.core.ibp import SamplerSpec, build_sampler
from repro_torch.launch import mcmc
from repro_torch.runtime import DriverConfig, MCMCDriver

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def X():
    return cambridge_data(N=48, sigma_n=0.5, seed=3)[0]


def _spec(tmp, **kw):
    base = dict(P=2, K_max=8, K_tail=4, L=2, n_iters=6, eval_every=3,
                ckpt_every=3, ckpt_dir=str(tmp), seed=5)
    base.update(kw)
    return SamplerSpec(**base)


def _state_arrays(gs, ss):
    out = {f"gs.{k}": v.numpy() for k, v in vars(gs).items()}
    out.update({f"ss.{k}": v.numpy() for k, v in vars(ss).items()})
    return out


def test_resume_repeats_uninterrupted_run_bitwise(tmp_path, X):
    gs_a, ss_a = MCMCDriver(X, _spec(tmp_path / "a"), device="cpu").run()
    MCMCDriver(X, _spec(tmp_path / "b"), device="cpu").run(n_iters=3)
    drv = MCMCDriver(X, _spec(tmp_path / "b"), device="cpu")
    gs_b, ss_b = drv.run()
    assert [r["it"] for r in drv.history] == [6]  # resumed at 3
    a, b = _state_arrays(gs_a, ss_a), _state_arrays(gs_b, ss_b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(gs_b.it) == 6


def test_checkpoints_cross_between_packages(tmp_path, X):
    # port -> reference: the reference's template reads the port's file
    drv = MCMCDriver(X, _spec(tmp_path / "p", n_iters=2), device="cpu")
    gs, ss = drv.run()
    jdrv = JDriver(X, JSpec(P=2, K_max=8, K_tail=4, L=2,
                            ckpt_dir=str(tmp_path / "p")))
    blob = jax_load_pytree(str(tmp_path / "p"), jdrv._template(), 2)
    np.testing.assert_array_equal(np.asarray(blob["Z_global"]),
                                  ss.Z.reshape(48, 8).numpy())
    for f in ("A", "pi", "active", "alpha", "sigma_x", "sigma_a", "p_prime",
              "it", "overflow", "tail_sat"):
        np.testing.assert_array_equal(np.asarray(getattr(blob["gs"], f)),
                                      getattr(gs, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(blob["gs"].key)), gs.key.numpy())
    assert int(blob["meta"]["it"]) == 2

    # reference -> port: a reference checkpoint resumes in the port
    jdir = tmp_path / "j"
    jdrv = JDriver(X, JSpec(P=2, K_max=8, K_tail=4, L=2, n_iters=2,
                            eval_every=2, ckpt_dir=str(jdir), seed=1))
    jgs, jss = jdrv.run()
    drv = MCMCDriver(X, _spec(jdir, n_iters=3), device="cpu")
    gs, ss = drv.run()
    assert int(gs.it) == 3 and [r["it"] for r in drv.history] == [3]
    # the columns the port kept active are the reference's, or births
    assert float((gs.active.numpy() - np.asarray(jgs.active)).min()) >= -1


def test_overflow_checkpoints_then_raises(tmp_path, X):
    drv = MCMCDriver(X, _spec(tmp_path, n_iters=10, overflow_every=2),
                     device="cpu")
    step = drv.sampler.step

    def overflowing_step(gs, ss):
        gs, ss = step(gs, ss)
        if int(gs.it) == 4:
            gs = dataclasses.replace(gs, overflow=gs.overflow + 1)
        return gs, ss

    drv.sampler.step = overflowing_step
    with pytest.raises(RuntimeError, match="overflow at it=3"):
        drv.run()
    assert sorted(os.listdir(tmp_path)) == ["step_000000003.npz",
                                            "step_000000004.npz"]


def test_cli_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "hist.json"
    mcmc.main(["--device", "cpu", "--N", "60", "--P", "2", "--iters", "4",
               "--eval-every", "2", "--K-max", "8", "--L", "2",
               "--ckpt-dir", str(tmp_path / "ck"), "--out", str(out)])
    hist = json.loads(out.read_text())
    assert [r["it"] for r in hist] == [2, 4]
    for r in hist:
        assert np.isfinite(r["joint_ll_eval"]) and np.isfinite(r["sigma_x"])
        assert 1 <= r["K"] <= 8
    assert "it=    4" in capsys.readouterr().out


@pytest.mark.parametrize("sync", ["staged", "fused"])
def test_cli_runs_shardmap_on_ranks(tmp_path, sync):
    """--driver shardmap in each of 4 gloo ranks (parallel.spawn): the
    same records on every rank, and rank 0 alone writes --out."""
    out = tmp_path / "hist.json"
    argv = ["--device", "cpu", "--driver", "shardmap", "--sync", sync,
            "--N", "60", "--P", "4", "--iters", "4", "--eval-every", "2",
            "--K-max", "8", "--L", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--out", str(out)]
    res = parallel.spawn(shardmap_ranks.cli, 4, argv, device="cpu",
                         timeout_s=300)
    assert [r["spec"] for r in res] == [("shardmap", sync)] * 4
    assert {r["backend"] for r in res} == {"gloo"}
    hist = json.loads(out.read_text())
    assert [r["it"] for r in hist] == [2, 4]
    for r in res:
        assert [h["joint_ll_train"] for h in r["history"]] == [
            h["joint_ll_train"] for h in hist]
    for r in hist:
        assert np.isfinite(r["joint_ll_eval"]) and 1 <= r["K"] <= 8
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_000000004.npz"]


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch, tmp_path, X):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sampler(SamplerSpec(P=2), X=X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MCMCDriver(X, _spec(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mcmc.main(["--N", "20", "--P", "2", "--iters", "1",
                   "--ckpt-dir", str(tmp_path / "ck"),
                   "--out", str(tmp_path / "h.json")])
    assert not (tmp_path / "ck").exists()


# a distributed layout builds only in a process that is a rank of a group
# of devices_needed ranks (here there is no group): data="shardmap" of P,
# chains="mesh" of C·P, or of C under data="vmap" (the reference's
# devices_needed and its wording "needs N devices (C chains x P data
# shards)")
NO_GROUP = r"P=4 needs a torch.distributed group of 4 ranks.*no group"
MESH_NO_GROUP = (r"chains='mesh' x data={data} with n_chains=2{p} needs a "
                 r"torch.distributed group of {n} ranks: driver='mesh' "
                 r"needs {n} devices \(2 chains x {P} data shards\).*is "
                 r"in no group \(0 ranks\)")


@pytest.mark.parametrize("make,exc,words", [
    (lambda X: build_sampler(SamplerSpec(data="shardmap"), X=X,
                             device="cpu"), ValueError, NO_GROUP),
    (lambda X: build_sampler(SamplerSpec(chains="mesh", n_chains=2), X=X,
                             device="cpu"), ValueError,
     MESH_NO_GROUP.format(data="'vmap'", p="", n=2, P=1)),
    (lambda X: build_sampler(SamplerSpec(chains="mesh", data="shardmap",
                                         n_chains=2), X=X, device="cpu"),
     ValueError, MESH_NO_GROUP.format(data="'shardmap'", p=", P=4", n=8,
                                      P=4)),
    (lambda X: MCMCDriver(X, DriverConfig(driver="shardmap"), device="cpu"),
     ValueError, NO_GROUP)],
    ids=["shardmap", "chains-mesh", "chains-mesh-x-shardmap",
         "driver-shardmap"])
def test_distributed_layout_refuses_outside_its_group(make, exc, words, X):
    with pytest.raises(exc, match=words):
        make(X)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_spec_config_and_cli_take_the_reference_backend(backend, tmp_path):
    assert SamplerSpec(backend=backend).backend == backend
    assert DriverConfig(backend=backend).to_spec().backend == backend
    assert JSpec(backend=backend).backend == backend
    drv = mcmc.main(["--device", "cpu", "--N", "20", "--P", "2", "--iters",
                     "1", "--K-max", "8", "--backend", backend,
                     "--ckpt-dir", str(tmp_path / "ck"),
                     "--out", str(tmp_path / "h.json")])
    assert drv.spec.backend == backend


def test_spec_config_and_cli_refuse_another_backend(tmp_path, capsys):
    for make in (lambda: SamplerSpec(backend="cuda"),
                 lambda: JSpec(backend="cuda")):
        with pytest.raises(ValueError,
                           match=r"backend='cuda' not in \('jnp', 'pallas'\)"):
            make()
    with pytest.raises(ValueError, match="DriverConfig: backend='cuda'"):
        DriverConfig(backend="cuda").to_spec()
    with pytest.raises(SystemExit):
        mcmc.main(["--device", "cpu", "--backend", "cuda",
                   "--ckpt-dir", str(tmp_path / "ck")])
    assert "invalid choice: 'cuda'" in capsys.readouterr().err


def test_spec_keeps_reference_validation():
    for kw in (dict(P=0), dict(K_tail=40, K_max=32), dict(L=0),
               dict(chol_refresh=0), dict(overflow_every=0),
               dict(K_init=33), dict(chains="bogus")):
        with pytest.raises(ValueError, match="SamplerSpec"):
            SamplerSpec(**kw)


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for m in _imported_modules(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, m)
    code = ("import sys, repro_torch, repro_torch.runtime, "
            "repro_torch.launch.mcmc, repro_torch.interop; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
