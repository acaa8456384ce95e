"""A frozen copy of the program's key handling (``repro_torch/prng.py``).

The reference draws the same random numbers as the program: a key is
two uint32 words, derivations are the splitmix64 finalizer on the host,
and a key's numbers come from a ``torch.Generator`` seeded from it. Kept
here so that the reference imports nothing of the program; a change to
the program's streams shows as a failed comparison.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_GOLDEN = 0x9E3779B97F4A7C15
_SPLIT_DOMAIN = 1 << 40


def _mix(x: int) -> int:
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def word(key) -> int:
    """A key as one 64-bit integer (a (2,) tensor or an int)."""
    if isinstance(key, int):
        return key & _M64
    hi, lo = (int(w) for w in key.reshape(-1).tolist())
    return ((hi & _M32) << 32) | (lo & _M32)


def key(seed: int) -> int:
    return seed & _M64


def fold_in(k: int, data: int) -> int:
    return _mix(k ^ _mix((data + _GOLDEN) & _M64))


def split(k: int, n: int) -> list[int]:
    return [fold_in(k, _SPLIT_DOMAIN + i) for i in range(n)]


def generator(k: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(_mix(k + _GOLDEN))
    return g
