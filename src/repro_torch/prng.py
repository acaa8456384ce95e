"""The sampler state's PRNG key and its derivations.

Replaces ``jax.random.key`` / ``fold_in`` / ``split`` as the reference
uses them (``repro/core/ibp/hybrid.py``). A key is two uint32 words, the
layout of ``jax.random.key_data`` in the reference's checkpoints, held
as a CPU uint32 tensor of shape (2,). Derivations are a fixed 64-bit hash
(the splitmix64 finalizer) computed on the host, so deriving a key never
touches the device. Random numbers come from ``generator(key, device)``:
a ``torch.Generator`` on the state's device seeded from the key, so a
resumed run repeats an uninterrupted one bitwise on the same device.

A chain-batched state holds C keys as a (C, 2) stack. ``fold_in`` and
``split`` apply to each row, so chain c's derivations are those of a
single-chain run started from key c; ``generator`` takes one key.

The streams are not JAX's: the reference and the port are compared
statistically, or fed the same pre-drawn numbers.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_GOLDEN = 0x9E3779B97F4A7C15
_SPLIT_DOMAIN = 1 << 40  # split(i) never collides with a uint32 fold_in


def _mix(x: int) -> int:
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _word64(key: torch.Tensor) -> int:
    hi, lo = (int(w) for w in key.tolist())
    return ((hi & _M32) << 32) | (lo & _M32)


def _from64(h: int) -> torch.Tensor:
    return torch.tensor([(h >> 32) & _M32, h & _M32], dtype=torch.uint32)


def key(seed: int) -> torch.Tensor:
    """Key of a seed: the words (seed >> 32, seed & 0xffffffff)."""
    return _from64(seed & _M64)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """A new key from ``k`` and an integer tag; a (C, 2) stack folds each
    row."""
    if k.dim() == 2:
        return torch.stack([fold_in(r, data) for r in k])
    return _from64(_mix(_word64(k) ^ _mix((data + _GOLDEN) & _M64)))


def split(k: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``n`` independent keys derived from ``k``, each (C, 2) when ``k``
    is a (C, 2) stack."""
    return [fold_in(k, _SPLIT_DOMAIN + i) for i in range(n)]


def generator(k: torch.Tensor, device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` whose stream is fixed by ``k``."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix(_word64(k) + _GOLDEN))
    return g
