"""The Cambridge bars (Griffiths and Ghahramani 2011): the features are
the configuration's own list, the same for every seed."""
from __future__ import annotations

import torch


def features(cfg: dict, seed: int, device) -> torch.Tensor:
    return torch.tensor(cfg["data"]["features"], dtype=torch.float32,
                        device=device)
