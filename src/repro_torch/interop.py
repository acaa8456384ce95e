"""Carry the reference package's sampler state, sample bank and LM
weights into the port, and the LM's weights and optimizer state back.

``from_reference`` takes the fields of the reference's ``HybridGlobal``
and ``HybridShard``, ``state_from_reference`` those of its ``IBPState``,
``bank_from_reference`` those of its ``SampleBank``, as numpy arrays
(the key as ``jax.random.key_data``, uint32[2]), and each returns the
port's counterpart on ``device``. A chain-batched state (the reference's
``init_multichain``) keeps its leading chain axis on every leaf, keys
(C, 2) included. Tests use them to start both packages from the same
state.

The LM's parameters are one a layer in the port and stacked (L, ...) in
the reference: ``reference_leaves`` groups a model's parameters as the
reference's leaves, in its leaf order (the optimizer's int8 scales and
noise go by these leaves), ``to_reference_tree`` and
``load_reference_tree`` convert such leaves to and from the reference's
nested numpy tree (the training checkpoints' layout), and
``params_from_reference`` / ``params_to_reference`` do so for a model.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.ibp.hybrid import HybridGlobal, HybridShard
from repro_torch.core.ibp.predict import SampleBank
from repro_torch.core.ibp.state import IBPState
from repro_torch.models.transformer import LM, _hybrid_layout

_HOST_FIELDS = ("key", "p_prime", "it")


def _field(name: str, value, dev: torch.device) -> torch.Tensor:
    a = np.asarray(value)
    if name == "key":
        return torch.as_tensor(a.astype(np.uint32).reshape(*a.shape[:-1], 2))
    if a.dtype.kind in "iu":
        t = torch.as_tensor(a.astype(np.int32))
    else:
        t = torch.as_tensor(a.astype(np.float32))
    return t if name in _HOST_FIELDS else t.to(dev)


def from_reference(gs_np: dict, ss_np: dict,
                   device: str | torch.device | None = None
                   ) -> tuple[HybridGlobal, HybridShard]:
    dev = _device.resolve(device)
    gs = HybridGlobal(**{k: _field(k, v, dev) for k, v in gs_np.items()})
    ss = HybridShard(**{k: _field(k, v, dev) for k, v in ss_np.items()})
    return gs, ss


def state_from_reference(st_np: dict,
                         device: str | torch.device | None = None
                         ) -> IBPState:
    dev = _device.resolve(device)
    return IBPState(**{k: _field(k, v, dev) for k, v in st_np.items()})


def bank_from_reference(fields: dict,
                        device: str | torch.device | None = None
                        ) -> SampleBank:
    dev = _device.resolve(device)
    # all of a bank's fields live on the device, its ``it`` too
    return SampleBank(**{k: _field(k, v, dev).to(dev)
                         for k, v in fields.items()})


_STACKED = ("layers", "enc_layers", "superblocks")


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _stack_lengths(cfg) -> dict[str, int]:
    n_super = (cfg.n_layers // len(_hybrid_layout(cfg)[0])
               if cfg.family == "hybrid" else 0)
    return {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
            "superblocks": n_super}


def reference_leaves(model: LM, cfg) -> dict:
    """The port's parameters grouped as the leaves of the reference's
    param tree, in its leaf order (``jax.tree``'s: dict keys sorted at
    every level, so the paths sorted as tuples).

    Returns {path: leaf}. Under ``layers``, ``enc_layers`` or the
    hybrid's ``superblocks`` a leaf is the list of the port's parameters
    of that path, one a layer (superblock) in order, which the reference
    stacks (L, ...); ``superblocks.2.b0.rec.w_a`` is item 2 of
    ``("superblocks", "b0", "rec", "w_a")``. Every other leaf, the
    hybrid's ``tail`` among them, is the one parameter of its path.
    Raises when a stack's length is not ``cfg``'s.
    """
    stacked: dict[tuple, dict[int, torch.nn.Parameter]] = {}
    out: dict[tuple, object] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in _STACKED:
            path = (parts[0],) + tuple(parts[2:])
            stacked.setdefault(path, {})[int(parts[1])] = p
        else:
            out[tuple(parts)] = p
    want = _stack_lengths(cfg)
    for path, layers in stacked.items():
        if sorted(layers) != list(range(want[path[0]])):
            raise ValueError(f"reference_leaves: {'/'.join(path)} has "
                             f"layers {sorted(layers)}; {cfg.name} stacks "
                             f"{want[path[0]]}")
        out[path] = [layers[i] for i in range(len(layers))]
    return {k: out[k] for k in sorted(out)}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_reference_tree(leaves: dict) -> dict:
    """``reference_leaves``-shaped leaves (parameters, or the optimizer's
    moments of the same shape) as the reference's nested tree of numpy
    arrays, a list stacked on a new leading axis."""
    tree: dict = {}
    for path, leaf in leaves.items():
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = np.stack([_numpy(t) for t in leaf]) \
            if isinstance(leaf, list) else _numpy(leaf)
    return tree


def load_reference_tree(leaves: dict, tree: dict, what: str = "") -> None:
    """Copy the reference's nested tree ``tree`` into ``leaves`` (the
    inverse of ``to_reference_tree``), in place, each value cast to its
    tensor's dtype and device. The port keeps the reference's (d_in,
    d_out) layouts, so nothing is transposed. Raises on a leaf no tensor
    takes, on a tensor no leaf sets, and on a shape that differs."""
    flat = _flatten(tree)
    for path in flat:
        if path not in leaves:
            raise ValueError(f"the reference leaf {'/'.join(path)} has no "
                             f"parameter in the port's {what}")
    unset = [p for p in leaves if p not in flat]
    if unset:
        raise ValueError(f"no reference leaf sets {sorted(unset)} of the "
                         f"port's {what}")
    for path, leaf in leaves.items():
        a = flat[path]
        parts = leaf if isinstance(leaf, list) else [leaf]
        values = list(a) if isinstance(leaf, list) else [a]
        if len(values) != len(parts) or any(
                tuple(v.shape) != tuple(t.shape)
                for v, t in zip(values, parts)):
            raise ValueError(
                f"{'/'.join(path)} is {len(parts)} x "
                f"{tuple(parts[0].shape)} in the port ({what}), "
                f"{tuple(a.shape)} in the reference")
        with torch.no_grad():
            for t, v in zip(parts, values):
                t.copy_(torch.from_numpy(np.array(v)))


def params_from_reference(params_np: dict, cfg,
                          device: str | torch.device | None = None) -> LM:
    """The port's model of ``cfg`` holding the reference's weights.

    ``params_np``: the reference's ``init_model`` param tree as numpy,
    set through ``reference_leaves``: a stacked (L, ...) leaf (an MoE
    expert leaf (L, E, ...)) goes to its layers' parameters, any other
    leaf, the hybrid's ``tail/t0/...`` among them, to the parameter of
    its path (``load_reference_tree``'s checks).
    """
    model = LM(cfg, _device.resolve(device))
    load_reference_tree(reference_leaves(model, cfg), params_np, cfg.name)
    return model


def params_to_reference(model: LM, cfg) -> dict:
    """The inverse of ``params_from_reference``: the model's weights as
    the reference's param tree of numpy arrays (``layers``,
    ``enc_layers`` and ``superblocks`` stacked (L, ...), the MoE experts
    (L, E, ...), the hybrid's ``tail`` unstacked)."""
    return to_reference_tree(reference_leaves(model, cfg))
