"""Atomic npz checkpointing with keep-k retention and auto-resume.

Port of ``repro/checkpoint/npz.py`` in the same file layout:
``<dir>/step_<n>.npz`` written as .tmp then ``os.replace`` (atomic on
POSIX), leaves named ``leaf_%05d``. Leaves are numbered in the order
``jax.tree.flatten`` gives the same tree in the reference: dict keys
sorted, dataclass fields in declaration order. The driver's checkpoint
tree ``{"gs", "Z_global", "meta"}`` therefore reads ``Z_global``, the
``HybridGlobal`` fields (the key as uint32[2]), then ``meta.it`` — so
one script can read either package's checkpoints.

``save_arrays`` / ``load_arrays`` are the self-describing counterpart
(named arrays, no template), which the posterior sample bank is saved
with; ``update_json`` is the tolerant read-modify-write of a small JSON
file. Both keep the reference's tmp + ``os.replace`` contract.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any

import numpy as np
import torch


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree]


def _unflatten(template: Any, leaves: list) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    return leaves.pop(0)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Any, step: int, keep: int = 3) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"step_{step:09d}.npz")
    tmp = fname + ".tmp"
    arrays = {f"leaf_{i:05d}": _to_numpy(x)
              for i, x in enumerate(_leaves(tree))}
    with open(tmp, "wb") as fh:  # file handle avoids numpy's suffix appending
        np.savez(fh, **arrays)
    os.replace(tmp, fname)
    for s in sorted(all_steps(path))[:-keep]:
        try:
            os.remove(os.path.join(path, f"step_{s:09d}.npz"))
        except OSError:
            pass
    return fname


def save_arrays(path: str, arrays: dict[str, Any]) -> str:
    """Atomic self-describing npz of named arrays (tensors go to the host
    first), loadable with no template."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{k: _to_numpy(v) for k, v in arrays.items()})
    os.replace(tmp, path)
    return path


def load_arrays(path: str) -> dict[str, np.ndarray]:
    """A ``save_arrays`` npz back as a name -> numpy array dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def update_json(path: str, update) -> str:
    """Read-modify-write of a small JSON file: ``update`` maps the current
    dict to the new one. A missing, corrupt or half-written file reads as
    {}; the write is tmp + ``os.replace``."""
    data: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (OSError, json.JSONDecodeError):
            data = {}
    data = update(data)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(data, fh, indent=1)
    os.replace(tmp, path)
    return path


def all_steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for f in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)\.npz", f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(path: str) -> int | None:
    steps = all_steps(path)
    return steps[-1] if steps else None


def load_pytree(path: str, template: Any, step: int) -> Any:
    """Load step ``step`` into the structure of ``template``; each leaf
    takes the dtype and device of the template's leaf."""
    fname = os.path.join(path, f"step_{step:09d}.npz")
    with np.load(fname) as data:
        leaves = [data[f"leaf_{i:05d}"] for i in range(len(data.files))]
    t_leaves = _leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"checkpoint {fname} has {len(leaves)} leaves but the template "
            f"has {len(t_leaves)} — the checkpoint predates a state-layout "
            f"change; clear or rename the checkpoint directory to start fresh"
        )
    cast = [torch.as_tensor(l).to(dtype=t.dtype, device=t.device)
            for l, t in zip(leaves, t_leaves)]
    return _unflatten(template, cast)


def restore(path: str, template: Any) -> tuple[Any, int] | None:
    """Load the newest complete checkpoint, or None if none exists."""
    step = latest_step(path)
    if step is None:
        return None
    return load_pytree(path, template, step), step
