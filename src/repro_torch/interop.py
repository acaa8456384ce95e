"""Carry the reference package's sampler state and sample bank into the
port.

``from_reference`` takes the fields of the reference's ``HybridGlobal``
and ``HybridShard``, ``state_from_reference`` those of its ``IBPState``,
``bank_from_reference`` those of its ``SampleBank``, as numpy arrays
(the key as ``jax.random.key_data``, uint32[2]), and each returns the
port's counterpart on ``device``. A chain-batched state (the reference's
``init_multichain``) keeps its leading chain axis on every leaf, keys
(C, 2) included. Tests use them to start both packages from the same
state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.ibp.hybrid import HybridGlobal, HybridShard
from repro_torch.core.ibp.predict import SampleBank
from repro_torch.core.ibp.state import IBPState
from repro_torch.models.transformer import LM

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


def params_from_reference(params_np: dict, cfg,
                          device: str | torch.device | None = None) -> LM:
    """The port's model of ``cfg`` holding the reference's weights.

    ``params_np``: the reference's ``init_model`` param tree as numpy. A
    leaf under ``layers``, ``enc_layers`` or the hybrid's ``superblocks``
    is stacked (L, ...) (an MoE expert leaf (L, E, ...)) and goes to
    layer (superblock) i's parameter of the same path,
    ``superblocks/b0/rec/w_a`` to ``superblocks.i.b0.rec.w_a``; every
    other leaf, the hybrid's ``tail/t0/...`` among them, to the parameter
    of its path. The port keeps the reference's (d_in, d_out) layouts, so
    nothing is transposed. Raises on a leaf no parameter
    takes, on a parameter no leaf sets, and on a shape that differs.
    """
    dev = _device.resolve(device)
    model = LM(cfg, dev)
    targets = dict(model.named_parameters())
    unset = set(targets)
    for path, a in _flatten(params_np).items():
        if path[0] in _STACKED:
            items = [(".".join((path[0], str(i)) + path[1:]), a[i])
                     for i in range(a.shape[0])]
        else:
            items = [(".".join(path), a)]
        for name, value in items:
            if name not in targets:
                raise ValueError(f"params_from_reference: the reference "
                                 f"leaf {'/'.join(path)} has no parameter "
                                 f"{name} in the port's {cfg.name}")
            t = targets[name]
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"params_from_reference: {name} is "
                                 f"{tuple(t.shape)} in the port, "
                                 f"{tuple(value.shape)} in the reference")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(value)))
            unset.discard(name)
    if unset:
        raise ValueError(f"params_from_reference: no reference leaf sets "
                         f"{sorted(unset)}")
    return model
