"""The cells' data, made on the device from ``--seed``.

Each configuration names its data in its file (``data``): its true
features come from the module of its ``kind`` (``datakinds/<kind>.py``),
its rows are the linear-Gaussian IBP's, X = Z A_true + σ_n ε. Rows are
drawn in a few large calls of one ``torch.Generator`` on the device; the
same seed gives the same rows, and the reference makes them again the
same way.
"""
from __future__ import annotations

import importlib

import torch

# the data's stream: a fixed tag mixed into the seed, apart from the
# sampler's own keys (which start from the seed itself)
_DATA_TAG = 0x5EED_DA7A


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B1 + _DATA_TAG) & 0xFFFFFFFFFFFFFFFF)
    return g


def features(cfg: dict, seed: int, device) -> torch.Tensor:
    """The true features (K_true, D), float32 on ``device``, from the
    data kind's module."""
    kind = cfg["data"]["kind"]
    mod = importlib.import_module(f"portbench.datakinds.{kind}")
    return mod.features(cfg, seed, device)


def rows(cfg: dict, seed: int, n: int, device, stream: int = 0
         ) -> torch.Tensor:
    """``n`` rows X = Z A_true + σ_n ε, Z_nk ~ Bernoulli(p), float32 on
    ``device``; ``stream`` keeps the training, held-out and request rows
    apart."""
    d = cfg["data"]
    A = features(cfg, seed, device)
    g = _gen(seed * 8 + 2 + stream, device)
    Z = (torch.rand((n, A.shape[0]), generator=g, device=device)
         < d["p"]).to(torch.float32)
    X = torch.randn((n, A.shape[1]), generator=g, dtype=torch.float32,
                    device=device)
    return torch.addmm(X.mul_(d["sigma_n"]), Z, A)


def train_eval(cfg: dict, seed: int, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training rows (N, D) and the held-out rows (N_eval, D)."""
    return (rows(cfg, seed, cfg["N"], device, stream=0),
            rows(cfg, seed, cfg["N_eval"], device, stream=1))
