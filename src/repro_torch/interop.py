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
