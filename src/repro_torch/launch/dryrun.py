"""Multi-pod dry run on meshes of H100s: every (arch x shape x mesh) cell
traced as one rank of a simulated cluster.

The counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell for TPU pods on 512 forced host devices and reads XLA's memory
and cost analyses and the partitioned HLO's collectives. The port has no
compile step, so this proves the same thing by running the port's
sharded steps (``models/lm.py``: train, prefill, decode on a mesh) once,
on fake tensors (``FakeTensorMode``: shapes and dtypes, no storage)
under a fake process group (``parallel.fake_world``: rank 0 of 256 or
512 ranks; collectives return at once): the step must run through, and
the record keeps what it did on that rank, the counters' collectives by
kind, bytes and group (``parallel.collective_bytes``: result shapes, the
reference's convention), its FLOPs (``FlopCounterMode``: the aten
operators' count, backward and rematerialisation included) and a memory
estimate (``MemoryTracker``: the peak of live storage bytes, the step's
arguments included, plus a cuBLAS workspace a thread that ran a
product) against the H100's 80 GB. Rank 0 stands for every rank: the
fit rules give every rank slices of one size and the steps are the same
program on each. Records go to
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` (incremental:
existing cells are kept unless --force).

The meshes are H100 clusters (``parallel.mesh.make_production_mesh``):
``pod1`` (32, 8) ("data", "model"), 256 cards; ``pod2`` (2, 32, 8)
("pod", "data", "model"), 512 cards.

``--ibp`` runs the paper's sampler instead (``run_ibp_cell``): one real
iteration of one rank's block on the device, under a fake group of every
card, its kernels launched for real.

Usage (``--device`` defaults to cuda and raises without a GPU):
  python -m repro_torch.launch.dryrun --arch granite-3-8b --mesh pod1
  python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both]
  python -m repro_torch.launch.dryrun --ibp --sync fused
  python -m repro_torch.launch.dryrun --device cpu --arch smollm-135m
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import device as _device
from repro_torch import parallel
from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, get_config,
                                 shape_applicable)
from repro_torch.interop import reference_leaves
from repro_torch.launch.specs import (abstract_caches, abstract_model,
                                      input_specs, param_bytes)
from repro_torch.models import (make_decode_step, make_prefill_step,
                                make_train_step)
from repro_torch.models.modules import tree_map
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import (HBM_BYTES, act_specs,
                                       layer_cache_specs,
                                       make_production_mesh,
                                       resolve_param_specs)

ARTIFACTS = os.path.join(os.path.dirname(__file__),
                         "../../../artifacts/dryrun_torch")

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# torch's cuBLAS workspace on an H100 (CUBLAS_WORKSPACE_CONFIG's default
# there, 4096 KiB x 8), allocated once for each cuBLAS handle: one a thread
# that runs a product on the card, the autograd engine's device thread
# among them
CUBLAS_WORKSPACE_BYTES = 32 * 2**20
_PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
             torch.ops.aten.baddbmm, torch.ops.aten.addbmm}
# the port's collectives by the reference's kinds (it has no permute)
KIND = {"all_reduce_sum": "all-reduce", "all_gather_rows": "all-gather",
        "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
        "all_to_all": "all-to-all"}


def _by_kind(group: str | None) -> tuple[dict, dict]:
    counts = dict.fromkeys(COLLECTIVE_OPS, 0)
    nbytes = dict.fromkeys(COLLECTIVE_OPS, 0)
    calls, sizes = (parallel.collective_counts(group),
                    parallel.collective_bytes(group))
    for op, kind in KIND.items():
        counts[kind] += calls[op]
        nbytes[kind] += sizes[op]
    return counts, nbytes


def collectives() -> tuple[dict, dict]:
    """The counters since their last reset as the reference's record:
    (``collectives``: bytes by kind, ``counts`` by kind, ``total``
    bytes; ``collectives_by_group``: {group name: {"counts", "bytes"}
    by kind}, the groups named by their mesh axes)."""
    counts, nbytes = _by_kind(None)
    out = dict(nbytes, counts=counts, total=sum(nbytes.values()))
    groups = {}
    for g in parallel.collective_groups():
        c, b = _by_kind(g)
        groups[g] = {"counts": c, "bytes": b}
    return out, groups


class MemoryTracker(TorchDispatchMode):
    """Live bytes of tensor storages: those passed to ``track`` and every
    one an operator run under this mode makes, each from when it is first
    seen until it is freed; ``peak`` is the most at once. On a CUDA
    device each storage is rounded up to the caching allocator's 512-byte
    blocks, and ``workspace`` counts a cuBLAS workspace for each thread
    that ran a product. The same on fake tensors (their storages' sizes)
    as on real ones; a storage resized in place keeps its first size."""

    def __init__(self, device_type: str = "cpu"):
        super().__init__()
        self.cuda = device_type == "cuda"
        self.block = 512 if self.cuda else 1
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._blas_threads: set[int] = set()

    @property
    def workspace(self) -> int:
        return len(self._blas_threads) * CUBLAS_WORKSPACE_BYTES

    def _free(self, n: int) -> None:
        self.live -= n

    def _add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = -(-st.nbytes() // self.block) * self.block
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def track(self, tree) -> int:
        """Count the storages of the tensors of ``tree`` (any nesting of
        dicts, lists, tuples and modules' parameters) not yet counted;
        returns their bytes."""
        return sum(self._add(t) for t in _tensors(tree))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.cuda and getattr(func, "overloadpacket", None) in _PRODUCTS:
            self._blas_threads.add(threading.get_ident())
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


def _tensors(tree) -> list:
    """The tensors of ``tree``, a module's parameters and buffers among
    them."""
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            out += [*x.parameters(), *x.buffers()]
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _bytes_not_in(tree, args, block: int) -> int:
    """Bytes of the storages of ``tree``'s tensors that are none of
    ``args``' (the step's outputs that are new)."""
    seen = {id(t.untyped_storage()) for t in _tensors(args)}
    total = 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += -(-st.nbytes() // block) * block
    return total


def build_step(cfg, shape, mesh, force_param_bytes: int | None = None, *,
               device="cuda"):
    """Returns (step, args): the port's step of ``shape.mode`` on the
    rank's ``mesh`` (``parallel.Mesh``, of the world this process is a
    rank of), and its arguments on ``device``, this rank's: the model
    sharded by the resolved parameter specs (``resolve_param_specs``
    with the mode and ``param_bytes``, so serving turns to
    inference-FSDP past the weight budget), AdamW's state for train, the
    whole batch (the steps take every rank's block from it) and, for
    decode, the caches sharded by ``layer_cache_specs``.

    Called under a ``FakeTensorMode`` (``run_cell`` does) it allocates
    nothing; outside one it builds real tensors, uninitialised, as the
    tests' real runs of the same step do."""
    dev = torch.device(device)
    serve = shape.mode != "train"
    model, pspecs = abstract_model(cfg, serve=serve, device=dev)
    pbytes = force_param_bytes or param_bytes(model, 2)
    parallel.shard_model(model, mesh, resolve_param_specs(
        pspecs, dict(model.named_parameters()), mesh,
        mode="serve" if serve else "train", param_bytes=pbytes))
    specs = act_specs(mesh, seq_len=shape.seq_len,
                      batch=shape.global_batch, mode=shape.mode)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in input_specs(cfg, shape).items()}
    if shape.mode == "train":
        opt = AdamW(lr=1e-4)
        state = opt.init(reference_leaves(model, cfg))
        return make_train_step(cfg, opt, specs), (model, state, batch)
    if shape.mode == "prefill":
        return make_prefill_step(cfg, specs), (model, batch)
    caches = abstract_caches(cfg, shape.global_batch, shape.seq_len, dev)
    cspecs = layer_cache_specs(cfg, caches, mesh)
    caches = tree_map(lambda t, s: parallel.shard_tensor(t, s, mesh),
                      caches, cspecs)
    return make_decode_step(cfg, specs, cspecs), (model, batch, caches)


def measure(step, args, device_type: str):
    """``step(*args)`` once under a ``MemoryTracker`` (``args`` counted
    first) and ``FlopCounterMode``: (its output, its FLOPs, the tracker,
    the arguments' bytes). The tracker sits under the FLOP counter, so it
    also counts the intermediates of the composite operators the counter
    decomposes, which their kernels allocate on a device too."""
    from torch.utils.flop_counter import FlopCounterMode

    mem = MemoryTracker(device_type)
    arg_bytes = mem.track(args)
    with mem, FlopCounterMode(display=False) as fc:
        out = step(*args)
    return out, fc.get_total_flops(), mem, arg_bytes


def production_mesh(mesh_name: str):
    """The ``MeshShape`` of ``pod1`` or ``pod2``."""
    return make_production_mesh(multi_pod=(mesh_name == "pod2"))


def trace_step(cfg, shape, mesh, force_param_bytes=None, *,
               device="cuda") -> dict:
    """One step of ``cfg`` at ``shape`` on fake tensors of ``device`` as
    rank 0 of ``mesh`` (a ``MeshShape``) in a fake world of its size: its
    FLOPs, the collectives it made and the memory estimate (a
    ``MemoryTracker`` over the step, its arguments counted first)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    names = tuple(mesh.axis_names)
    sizes = tuple(mesh.axis_size(a) for a in names)
    t0 = time.time()
    with parallel.fake_world(0, math.prod(sizes), device) as w:
        mesh = parallel.make_mesh(sizes, names)
        with FakeTensorMode():
            step, args = build_step(cfg, shape, mesh, force_param_bytes,
                                    device=w.device)
            parallel.reset_collective_counts()
            out, flops, mem, arg_bytes = measure(step, args, w.device.type)
            coll, by_group = collectives()
            out_bytes = _bytes_not_in(out, args, mem.block)
    peak = mem.peak + mem.workspace
    return dict(
        trace_s=round(time.time() - t0, 1), flops=float(flops),
        bytes_accessed=-1.0, collectives=coll,
        collectives_by_group=by_group,
        memory=dict(argument_size_in_bytes=arg_bytes,
                    output_size_in_bytes=out_bytes,
                    temp_size_in_bytes=peak - arg_bytes,
                    workspace_bytes=mem.workspace, peak_bytes=peak,
                    fits=peak <= HBM_BYTES))


def _error(e: Exception) -> dict:
    return dict(status="error", error=f"{type(e).__name__}: {e}",
                traceback=traceback.format_exc()[-4000:])


def _write(rec: dict, path: str) -> dict:
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def _cached(path: str, force: bool) -> dict | None:
    if os.path.exists(path) and not force:
        with open(path) as fh:
            return json.load(fh)
    return None


def run_cell(arch: str, shape, mesh_name: str, force: bool = False, *,
             device="cuda", out_dir: str | None = None) -> dict:
    """Trace one cell (``trace_step``) and write its record under
    ``out_dir`` (default ``ARTIFACTS``); a cell ``shape_applicable``
    refuses is ``skipped`` with its reason, and an exception is recorded
    as ``error`` with its traceback."""
    out_dir = out_dir or ARTIFACTS
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape.name}__{mesh_name}.json")
    rec = _cached(out_path, force)
    if rec is not None:
        return rec
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "mode": shape.mode, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        return _write(rec, out_path)
    dev = _device.resolve(device)
    try:
        rec.update(status="ok", **trace_step(
            cfg, shape, production_mesh(mesh_name), device=dev))
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec.update(_error(e))
    return _write(rec, out_path)


def run_ibp_cell(mesh_name: str, *, N: int = 1 << 20, K_max: int = 64,
                 K_tail: int = 8, L: int = 5, force: bool = False,
                 tag: str = "mcmc_1m", sync: str = "staged", device="cuda",
                 out_dir: str | None = None) -> dict:
    """The paper's hybrid sampler on the production mesh: N observations
    of Cambridge data (D=36, seed 0) over every card (the paper's P
    processors = 256 or 512, one ("data",) mesh). Unlike the LM cells it
    runs for real: this process is rank p' = 0 of a fake world of P
    ranks and runs one iteration of its block of N/P rows on ``device``
    with p' set to its rank, so the tail runs too and every kernel of
    the iteration launches.

    The record keeps the collectives (by kind, count, bytes and group),
    the kernels' launches, ``peak_bytes`` (the device's
    ``max_memory_allocated`` over the iteration, from a reset after the
    state is built: the rank's whole use in a process that holds nothing
    else, as the CLI's; on the CPU a ``MemoryTracker``'s), the
    iteration's
    ``wall_s`` and the aten operators' FLOPs (``flops_scope`` "aten":
    the kernels' arithmetic is not in it). The sampler's output is not
    kept: in the fake world every all-reduce returns this rank's own
    payload, so the master's draws see one block's statistics."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.ibp import IBPHypers, SamplerSpec, build_sampler
    from repro_torch.data import cambridge_data
    from repro_torch.kernels import launch_counts, reset_launch_counts

    out_dir = out_dir or ARTIFACTS
    os.makedirs(out_dir, exist_ok=True)
    name = f"ibp-hybrid__{tag}" + ("" if sync == "staged" else f"-{sync}")
    out_path = os.path.join(out_dir, f"{name}__{mesh_name}.json")
    rec = _cached(out_path, force)
    if rec is not None:
        return rec
    mesh = production_mesh(mesh_name)
    P_ = math.prod(mesh.shape.values())  # every card is one processor p
    p_prime = 0
    rec = {
        "arch": "ibp-hybrid", "shape": tag, "mesh": mesh_name,
        "mode": "mcmc", "seq_len": 36, "global_batch": N, "sync": sync,
        "P": P_, "K_max": K_max, "K_tail": K_tail, "L": L,
        "rank": p_prime, "rows_per_rank": N // P_,
    }
    dev = _device.resolve(device)
    t0 = time.time()
    try:
        X = cambridge_data(N=N, seed=0)[0]
        with parallel.fake_world(p_prime, P_, dev) as w:
            cuda = w.device.type == "cuda"
            spec = SamplerSpec(P=P_, L=L, K_max=K_max, K_tail=K_tail,
                               data="shardmap", sync=sync)
            sampler = build_sampler(spec, IBPHypers(), X, device=w.device)
            gs, ss = sampler.init()
            gs = dataclasses.replace(
                gs, p_prime=torch.tensor(p_prime, dtype=torch.int32))
            mem = MemoryTracker(w.device.type)
            mem.track((sampler.Xs, vars(gs), vars(ss)))
            if cuda:
                torch.cuda.synchronize(w.device)
                torch.cuda.reset_peak_memory_stats(w.device)
            reset_launch_counts()
            parallel.reset_collective_counts()
            t1 = time.perf_counter()
            with mem, FlopCounterMode(display=False) as fc:
                sampler.step(gs, ss)
            if cuda:
                torch.cuda.synchronize(w.device)
            wall = time.perf_counter() - t1
            peak = torch.cuda.max_memory_allocated(w.device) if cuda \
                else mem.peak
            coll, by_group = collectives()
            launches = {k: v for k, v in launch_counts().items() if v}
        rec.update(
            status="ok", trace_s=round(time.time() - t0, 1), wall_s=wall,
            flops=float(fc.get_total_flops()), flops_scope="aten",
            bytes_accessed=-1.0, collectives=coll,
            collectives_by_group=by_group, launches=launches,
            device=str(dev) if not cuda else torch.cuda.get_device_name(dev),
            memory=dict(peak_bytes=peak, fits=peak <= HBM_BYTES,
                        peak_source="cuda.max_memory_allocated" if cuda
                        else "MemoryTracker"))
    except Exception as e:
        rec.update(_error(e))
    return _write(rec, out_path)


def _probe_depths(cfg) -> tuple[int, int]:
    """Layer counts for the two depth probes (pattern-preserving)."""
    if cfg.family == "hybrid":
        p = len(cfg.rglru_pattern or ("rec", "rec", "attn"))
        return p, 2 * p
    return 1, 2


def run_probe(arch: str, shape, mesh_name: str, force: bool = False, *,
              device="cuda", out_dir: str | None = None) -> dict:
    """Trace the reference's two reduced-depth variants, at the FULL
    model's parameter bytes so that the serve FSDP decision (and the
    collective pattern) matches the real cell. The reference needs them
    because XLA's cost analysis counts a scan body once; the port traces
    every layer, so for a uniform stack the extrapolation
        total = probe(L1) + (L - L1) / (L2 - L1) * (probe(L2) - probe(L1))
    equals the full cell's FLOPs, which checks the reference's reading.
    Each probe also keeps its peak estimate (``peak_bytes``)."""
    out_dir = out_dir or ARTIFACTS
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(
        out_dir, f"probe__{arch}__{shape.name}__{mesh_name}.json")
    rec = _cached(out_path, force)
    if rec is not None:
        return rec
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=why)
        return _write(rec, out_path)
    dev = _device.resolve(device)
    try:
        full = param_bytes(abstract_model(cfg, serve=shape.mode != "train")[0])
        L1, L2 = _probe_depths(cfg)
        probes = {}
        for L in (L1, L2):
            sub = {"n_layers": L}
            if cfg.family == "encdec":
                sub["n_enc_layers"] = L
            r = trace_step(dataclasses.replace(cfg, **sub), shape,
                           production_mesh(mesh_name), force_param_bytes=full,
                           device=dev)
            probes[str(L)] = {"flops": r["flops"],
                              "bytes_accessed": r["bytes_accessed"],
                              "collective_total": r["collectives"]["total"],
                              "peak_bytes": r["memory"]["peak_bytes"]}
        rec.update(status="ok", L=cfg.n_layers, L1=L1, L2=L2, probes=probes)
    except Exception as e:
        rec.update(_error(e))
    return _write(rec, out_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="trace reduced-depth variants for the roofline "
                         "extrapolation instead of the full cells")
    ap.add_argument("--ibp", action="store_true",
                    help="run the IBP hybrid-sampler cell (2^20 rows over "
                         "all cards) instead of LM cells")
    ap.add_argument("--sync", choices=["staged", "fused"], default="staged")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]

    if args.ibp:
        bad = 0
        for mesh_name in meshes:
            rec = run_ibp_cell(mesh_name, force=args.force, sync=args.sync,
                               device=args.device)
            extra = ""
            if rec["status"] == "ok":
                c = rec["collectives"]
                extra = (f"wall={rec['wall_s']:.3f}s "
                         f"AR_count={c['counts']['all-reduce']} "
                         f"coll={c['total'] / 2**20:.2f}MiB "
                         f"flops={rec['flops']:.3g} "
                         f"peak={rec['memory']['peak_bytes'] / 2**20:.1f}MiB "
                         f"launches={rec['launches']}")
            elif rec["status"] == "error":
                extra = rec["error"][:200]
            print(f"[{rec['status']:7s}] ibp-hybrid ({args.sync:6s}) "
                  f"{mesh_name} {extra}", flush=True)
            bad += rec["status"] == "error"
        return 1 if bad else 0
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = (
        ALL_SHAPES
        if args.all or not args.shape
        else [s for s in ALL_SHAPES if s.name == args.shape]
    )

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                if args.probe:
                    rec = run_probe(arch, shape, mesh_name, force=args.force,
                                    device=args.device)
                    print(f"[{rec['status']:7s}] probe {arch:24s} "
                          f"{shape.name:12s} {mesh_name}", flush=True)
                    n_ok += rec["status"] == "ok"
                    n_skip += rec["status"] == "skipped"
                    n_err += rec["status"] == "error"
                    continue
                rec = run_cell(arch, shape, mesh_name, force=args.force,
                               device=args.device)
                tag = rec["status"]
                n_ok += tag == "ok"
                n_skip += tag == "skipped"
                n_err += tag == "error"
                extra = ""
                if tag == "ok":
                    mem_gb = rec["memory"]["peak_bytes"] / 2**30
                    extra = (
                        f"trace={rec['trace_s']}s flops/dev="
                        f"{rec['flops']:.3g} coll/dev="
                        f"{rec['collectives']['total'] / 2**20:.1f}MiB "
                        f"peak={mem_gb:.2f}GiB"
                        + ("" if rec["memory"]["fits"] else " (over 80 GB)")
                    )
                elif tag == "error":
                    extra = rec["error"][:160]
                print(f"[{tag:7s}] {arch:24s} {shape.name:12s} {mesh_name} "
                      f"{extra}", flush=True)
    print(f"\nok={n_ok} skipped={n_skip} error={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
